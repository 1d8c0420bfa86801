"""K8, the GLOW coupling with 3x3-conv subnets: the port's plain forms (what
``ops/cuda/coupling3x3.py`` runs on CPU tensors) held against the JAX
package's Pallas kernels in interpret mode.

Inputs and HWIO params are drawn with numpy and carried over with
``models/convert.py``. Tolerances: values atol/rtol 2e-5 (fp32 sums in
another order; the TPU kernels' Abramowitz-Stegun atan polynomial against
``torch.atan``, some 1e-7 apart); the inverse round trip 1e-4; the hand-
derived backward against ``_half_banded_bwd``: dx 2e-4, weight and bias
leaves 2e-3 (sums over every pixel in another order, as the 1x1 backward's
tests); gradients of the autograd ops against ``jax.grad`` the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.ops.pallas import coupling3x3 as JK
from sin_inn_tpu_torch.models.convert import glow_params_from_jax
from sin_inn_tpu_torch.ops import coupling as TC
from sin_inn_tpu_torch.ops import subnet as TS
from sin_inn_tpu_torch.ops.cuda import coupling as K
from sin_inn_tpu_torch.ops.cuda import coupling3x3 as K8
from torch_port_helpers import one_torch_thread  # noqa: F401

CLAMP = 1.2


def _np_params(c, len1, hidden, seed):
    rng = np.random.RandomState(seed)

    def conv(cin, cout):
        bound = 1.0 / np.sqrt(cin * 9)
        return {"w": rng.uniform(-bound, bound, (3, 3, cin, cout))
                .astype(np.float32),
                "b": rng.uniform(-bound, bound, cout).astype(np.float32)}

    len2 = c - len1
    return {"s1": {"conv1": conv(len1, hidden),
                   "conv2": conv(hidden, 2 * len2)},
            "s2": {"conv1": conv(len2, hidden),
                   "conv2": conv(hidden, 2 * len1)}}


def _setup(shape, len1, hidden, seed=0, scale=1.0):
    jp = _np_params(shape[-1], len1, hidden, seed)
    x = (np.random.RandomState(seed + 100).randn(*shape) * scale).astype(
        np.float32)
    return jp, glow_params_from_jax(jp), x


def _jax_tree(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got), np.asarray(ref),
                               atol=tol, rtol=tol)


SMALL = ((2, 6, 10, 16), 8, 32)


@pytest.mark.parametrize("inverse", [False, True])
def test_fused_whole_coupling_matches_pallas(inverse):
    shape, len1, hidden = SMALL
    jp, tp, x = _setup(shape, len1, hidden)
    jfn = JK.fused_glow3_inverse if inverse else JK.fused_glow3_forward
    tfn = K8.fused_glow3_inverse if inverse else K8.fused_glow3_forward
    ref = jfn(_jax_tree(jp), jnp.asarray(x), CLAMP, len1, interpret=True)
    _close(tfn(tp, torch.tensor(x), CLAMP, len1), ref, 2e-5)


@pytest.mark.parametrize("inverse", [False, True])
def test_half_coupling_matches_pallas(inverse):
    shape, len1, hidden = SMALL
    jp, tp, x = _setup(shape, len1, hidden, seed=1)
    x_in, x_aff = x[..., len1:], x[..., :len1]
    ref = JK.half_coupling_3x3(_jax_tree(jp["s2"]), jnp.asarray(x_in),
                               jnp.asarray(x_aff), CLAMP, inverse,
                               interpret=True)
    got = K8.half_coupling_3x3(tp["s2"], torch.tensor(x_in),
                               torch.tensor(x_aff), CLAMP, inverse)
    _close(got, ref, 2e-5)
    _close(K8.half_coupling_3x3_plain(tp["s2"], torch.tensor(x_in),
                                      torch.tensor(x_aff), CLAMP, inverse),
           ref, 2e-5)


def test_halves_match_pallas_and_invert():
    shape, len1, hidden = SMALL
    jp, tp, x = _setup(shape, len1, hidden, seed=2)
    ref = JK.glow3_forward_halves(_jax_tree(jp), jnp.asarray(x), CLAMP, len1,
                                  interpret=True)
    y = K8.glow3_forward_halves(tp, torch.tensor(x), CLAMP, len1)
    _close(y, ref, 2e-5)
    ref_inv = JK.glow3_inverse_halves(_jax_tree(jp), ref, CLAMP, len1,
                                      interpret=True)
    back = K8.glow3_inverse_halves(tp, y, CLAMP, len1)
    _close(back, ref_inv, 2e-5)
    _close(back, x, 1e-4)


@pytest.mark.parametrize("shape", [(2, 11, 16, 20), (1, 5, 13, 20),
                                   (2, 1, 9, 20)])
def test_banded_coupling_matches_pallas(shape):
    """H = 11 is not a multiple of the TPU's band of 8; an odd width (13)
    and H = 1 reach every border rule."""
    len1, hidden = 8, 16
    jp, tp, x = _setup(shape, len1, hidden, seed=3, scale=0.5)
    jfwd, jinv = JK.make_fused_coupling3_banded(CLAMP, len1, interpret=True)
    tfwd, tinv = K8.make_fused_coupling3_banded(CLAMP, len1)
    ref = jfwd(_jax_tree(jp), jnp.asarray(x))
    y = tfwd(tp, torch.tensor(x))
    _close(y, ref, 2e-5)
    _close(tinv(tp, y), x, 1e-4)
    _close(tinv(tp, y), jinv(_jax_tree(jp), ref), 2e-5)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(2, 11, 16, 20), (1, 3, 13, 20)])
def test_plain_backward_matches_pallas_backward(inverse, shape):
    len1, hidden = 8, 16
    jp, tp, x = _setup(shape, len1, hidden, seed=4, scale=0.5)
    g = np.random.RandomState(5).randn(*shape[:3], len1).astype(np.float32)
    x_in, x_aff = x[..., len1:], x[..., :len1]
    jd, jdx_in, jdx_aff = JK._half_banded_bwd(
        _jax_tree(jp["s2"]), jnp.asarray(x_in), jnp.asarray(x_aff),
        jnp.asarray(g), CLAMP, inverse, interpret=True)
    td, tdx_in, tdx_aff = K8.half_coupling_3x3_backward(
        tp["s2"], torch.tensor(x_in), torch.tensor(x_aff), torch.tensor(g),
        CLAMP, inverse)
    _close(tdx_in, jdx_in, 2e-4)
    _close(tdx_aff, jdx_aff, 2e-4)
    for conv in ("conv1", "conv2"):
        _close(td[conv]["w"].permute(2, 3, 1, 0), jd[conv]["w"], 2e-3)
        _close(td[conv]["b"], jd[conv]["b"], 2e-3)


def _grads_vs_jax(jop, top, jp, tp, x):
    """Gradients of sum(sin(op(params, x))) in both packages."""
    def jloss(p, v):
        return jnp.sum(jnp.sin(jop(p, v)))

    gp, gx = jax.grad(jloss, argnums=(0, 1))(_jax_tree(jp), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    for t in K.param_leaves(tp):
        t.requires_grad_(True)
    torch.sin(top(tp, xt)).sum().backward()
    _close(xt.grad, gx, 2e-4)
    for s, c, k in K.LEAVES:
        got = tp[s][c][k].grad
        if k == "w":
            got = got.permute(2, 3, 1, 0)
        _close(got, gp[s][c][k], 2e-3)


@pytest.mark.parametrize("inverse", [False, True])
def test_banded_op_gradients_match_jax(inverse):
    shape, len1, hidden = (2, 11, 16, 20), 8, 16
    jp, tp, x = _setup(shape, len1, hidden, seed=6, scale=0.5)
    jops = JK.make_fused_coupling3_banded(CLAMP, len1, interpret=True)
    tops = K8.make_fused_coupling3_banded(CLAMP, len1)
    _grads_vs_jax(jops[int(inverse)], tops[int(inverse)], jp, tp, x)


@pytest.mark.parametrize("inverse", [False, True])
def test_recompute_op_gradients_match_jax(inverse):
    shape, len1, hidden = SMALL
    jp, tp, x = _setup(shape, len1, hidden, seed=7)
    jops = JK.make_fused_coupling3(CLAMP, len1, interpret=True)
    # the JAX package's recompute runs XLA's fp32 convolutions on the CPU
    tops = K8.make_fused_coupling3(CLAMP, len1, compute="highest")
    _grads_vs_jax(jops[int(inverse)], tops[int(inverse)], jp, tp, x)


def test_plain_backward_matches_autograd_of_conv_route():
    """The hand-derived backward is the VJP of the convolution route."""
    shape, len1, hidden = (2, 7, 9, 16), 8, 32
    _, tp, x = _setup(shape, len1, hidden, seed=8)
    g = torch.randn(shape[:3] + (len1,),
                    generator=torch.Generator().manual_seed(9))
    x_in, x_aff = torch.tensor(x[..., len1:]), torch.tensor(x[..., :len1])
    for inverse in (False, True):
        sub = {c: {k: t.clone().requires_grad_(True) for k, t in conv.items()}
               for c, conv in tp["s2"].items()}
        xi = x_in.clone().requires_grad_(True)
        xa = x_aff.clone().requires_grad_(True)
        r = TS.conv_subnet_apply(sub, xi, compute="highest")
        le = TC.glow_log_e(r[..., :len1], CLAMP)
        t = r[..., len1:]
        y = (xa - t) * torch.exp(-le) if inverse else torch.exp(le) * xa + t
        y.backward(g)
        dsub, dxi, dxa = K8.half_coupling_3x3_backward_plain(
            tp["s2"], x_in, x_aff, g, CLAMP, inverse)
        torch.testing.assert_close(dxi, xi.grad, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(dxa, xa.grad, atol=1e-5, rtol=1e-5)
        for c in ("conv1", "conv2"):
            for k in ("w", "b"):
                torch.testing.assert_close(dsub[c][k], sub[c][k].grad,
                                           atol=1e-4, rtol=1e-4)


def test_wrappers_route_by_device_and_count_nothing_on_cpu():
    shape, len1, hidden = SMALL
    _, tp, x = _setup(shape, len1, hidden, seed=10)
    K8.reset_launch_counts()
    xt = torch.tensor(x)
    y = K8.fused_glow3_forward(tp, xt, CLAMP, len1)
    K8.half_coupling_3x3_backward(tp["s1"], xt[..., :len1], xt[..., len1:],
                                  y[..., len1:], CLAMP)
    assert K8.launch_counts() == {"half_coupling_3x3": 0,
                                  "half_coupling_3x3_backward": 0}
    with pytest.raises(ValueError, match="expected"):
        K8.half_coupling_3x3(tp["s1"], xt[..., 1:len1], xt[..., len1:], CLAMP)
    with pytest.raises(ValueError, match="NHWC"):
        K8.half_coupling_3x3(tp["s1"], xt[0], xt[0], CLAMP)
    with pytest.raises(ValueError, match="no coupling kernel"):
        K8.half_coupling_3x3(tp["s2"], xt.to("meta")[..., len1:],
                             xt.to("meta")[..., :len1], CLAMP)


def test_relu_gate_slack_covers_a_gate_that_flips():
    """One conv1 pre-activation set to 0 and the bias nudged by 3e-6 either
    way: the gate flips, dx_in, dW1 and db1 move by that term, and
    ``relu_gate_slack`` bounds the move (the rest moves continuously, some
    1e-6)."""
    shape, len1, hidden = (2, 7, 9, 16), 8, 32
    _, tp, x = _setup(shape, len1, hidden, seed=11)
    x_in, x_aff = torch.tensor(x[..., len1:]), torch.tensor(x[..., :len1])
    g = torch.randn(x_aff.shape, generator=torch.Generator().manual_seed(12))
    sub = tp["s2"]
    z = K8._conv3x3(x_in, sub["conv1"]["w"], sub["conv1"]["b"])
    b1 = sub["conv1"]["b"].clone()
    b1[5] -= z[0, 3, 4, 5]
    runs = []
    for nudge in (-3e-6, 3e-6):
        b = b1.clone()
        b[5] += nudge
        s = {"conv1": {"w": sub["conv1"]["w"], "b": b},
             "conv2": sub["conv2"]}
        runs.append((K8.half_coupling_3x3_backward_plain(s, x_in, x_aff, g,
                                                         CLAMP),
                     K8.relu_gate_slack(s, x_in, x_aff, g, CLAMP)))
    (lo, slack), (hi, _) = runs
    moves = [(lo[1], hi[1], slack[0]),
             (lo[0]["conv1"]["w"], hi[0]["conv1"]["w"], slack[1]),
             (lo[0]["conv1"]["b"], hi[0]["conv1"]["b"], slack[2])]
    for a, b, sl in moves:
        assert (a - b).abs().max() > 1e-3          # the flipped term
        assert ((a - b).abs() <= sl + 1e-5).all()
    zero = K8.relu_gate_slack(sub, x_in, x_aff, g, CLAMP, tau=0.0)
    assert all(not t.any() for t in zero)

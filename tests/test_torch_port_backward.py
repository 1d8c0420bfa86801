"""The port's backward of the fused 1x1 coupling held against the JAX
package on the CPU.

The plain versions of K3 and K4 (the VJPs of the fused forward and
inverse) against the Pallas backward kernels run in interpret mode, and
against torch autograd of the plain forward; the autograd Functions that
wrap K1-K4 on CPU tensors. Tolerance: dx atol/rtol 2e-4 and the weight and
bias gradients atol/rtol 2e-3, the JAX package's own bound for its
backward kernels (tests/test_pallas_kernels.py). The CUDA kernels run only
on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.ops import subnet as JS
from sin_inn_tpu.ops.pallas import coupling as JK
from sin_inn_tpu_torch.models.convert import glow_params_from_jax
from sin_inn_tpu_torch.ops.cuda import coupling as TK
from torch_port_helpers import one_torch_thread  # noqa: F401

CLAMP = 1.2
C, LEN1, HIDDEN = 16, 8, 32


@pytest.fixture(params=[(2, 8, 8), (1, 5, 7)], ids=["2x8x8", "35rows"])
def setup(request):
    shape = request.param + (C,)
    k1, k2 = jax.random.split(jax.random.key(0))
    jp = {"s1": JS.conv_subnet_init(k1, LEN1, 2 * (C - LEN1), 1, HIDDEN),
          "s2": JS.conv_subnet_init(k2, C - LEN1, 2 * LEN1, 1, HIDDEN)}
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    tp = glow_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jp, tp, x, g


def _assert_close(tdp, tdx, jdp, jdx):
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), atol=2e-4,
                               rtol=2e-4)
    # the JAX gradients have the params' tree: convert them the same way
    ref = glow_params_from_jax(jax.tree_util.tree_map(np.asarray, jdp))
    for (s, c, k), a, b in zip(TK.LEAVES, TK.param_leaves(tdp),
                               TK.param_leaves(ref)):
        assert a.shape == b.shape, (s, c, k)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3,
                                   rtol=2e-3, err_msg=f"{s}.{c}.{k}")


@pytest.mark.parametrize("inverse", [False, True], ids=["K3", "K4"])
def test_plain_backward_matches_pallas(setup, inverse):
    jp, tp, x, g = setup
    jfn = (JK.fused_glow_inverse_backward_1x1 if inverse
           else JK.fused_glow_backward_1x1)
    tfn = (TK.fused_glow_inverse_backward_1x1_plain if inverse
           else TK.fused_glow_backward_1x1_plain)
    jdp, jdx = jfn(jp, jnp.asarray(x), jnp.asarray(g), CLAMP, LEN1,
                   interpret=True)
    tdp, tdx = tfn(tp, torch.from_numpy(x), torch.from_numpy(g), CLAMP, LEN1)
    _assert_close(tdp, tdx, jdp, jdx)


def _autograd_of_plain_forward(tp, x, g, inverse):
    leaves = [t.clone().requires_grad_(True) for t in TK.param_leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_(True)
    fwd = (TK.fused_glow_inverse_1x1_plain if inverse
           else TK.fused_glow_forward_1x1_plain)
    out = fwd(TK.params_from_leaves(leaves), xt, CLAMP, LEN1)
    (out * torch.from_numpy(g)).sum().backward()
    return TK.params_from_leaves([t.grad for t in leaves]), xt.grad


@pytest.mark.parametrize("inverse", [False, True], ids=["K3", "K4"])
def test_plain_backward_matches_autograd(setup, inverse):
    _, tp, x, g = setup
    tfn = (TK.fused_glow_inverse_backward_1x1_plain if inverse
           else TK.fused_glow_backward_1x1_plain)
    dp, dx = tfn(tp, torch.from_numpy(x), torch.from_numpy(g), CLAMP, LEN1)
    rp, rx = _autograd_of_plain_forward(tp, x, g, inverse)
    torch.testing.assert_close(dx, rx, atol=2e-5, rtol=2e-5)
    for a, b in zip(TK.param_leaves(dp), TK.param_leaves(rp)):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("inverse", [False, True], ids=["K1K3", "K2K4"])
def test_autograd_functions_on_cpu(setup, inverse):
    """The Functions run the plain versions on CPU tensors: the same value
    as the plain forward, the same gradients as the plain backward."""
    _, tp, x, g = setup
    leaves = [t.clone().requires_grad_(True) for t in TK.param_leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_(True)
    TK.reset_launch_counts()
    out = TK.fused_coupling(TK.params_from_leaves(leaves), xt, CLAMP, LEN1,
                            inverse=inverse)
    fwd = (TK.fused_glow_inverse_1x1_plain if inverse
           else TK.fused_glow_forward_1x1_plain)
    assert torch.equal(out.detach(), fwd(tp, torch.from_numpy(x), CLAMP,
                                         LEN1))
    (out * torch.from_numpy(g)).sum().backward()
    bwd = (TK.fused_glow_inverse_backward_1x1_plain if inverse
           else TK.fused_glow_backward_1x1_plain)
    rp, rx = bwd(tp, torch.from_numpy(x), torch.from_numpy(g), CLAMP, LEN1)
    assert torch.equal(xt.grad, rx)
    for t, r in zip(leaves, TK.param_leaves(rp)):
        assert t.grad.shape == t.shape and torch.equal(t.grad, r)
    # CPU tensors never reach a kernel
    assert set(TK.launch_counts().values()) == {0}


def test_functions_save_only_input_and_weights(setup):
    _, tp, x, _ = setup
    leaves = [t.clone().requires_grad_(True) for t in TK.param_leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = TK.fused_coupling(TK.params_from_leaves(leaves), xt, CLAMP, LEN1)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 9 and saved[0] is xt
    assert all(s is t for s, t in zip(saved[1:], leaves))


@pytest.mark.parametrize("inverse", [False, True], ids=["K3", "K4"])
def test_cuda_backward_wrapper_takes_plain_version_on_cpu(setup, inverse):
    _, tp, x, g = setup
    wrapper = (TK.fused_glow_inverse_backward_1x1 if inverse
               else TK.fused_glow_backward_1x1)
    plain = (TK.fused_glow_inverse_backward_1x1_plain if inverse
             else TK.fused_glow_backward_1x1_plain)
    TK.reset_launch_counts()
    dp, dx = wrapper(tp, torch.from_numpy(x), torch.from_numpy(g), CLAMP,
                     LEN1)
    rp, rx = plain(tp, torch.from_numpy(x), torch.from_numpy(g), CLAMP, LEN1)
    assert torch.equal(dx, rx)
    assert all(torch.equal(a, b) for a, b in zip(TK.param_leaves(dp),
                                                 TK.param_leaves(rp)))
    assert TK.launch_counts() == {
        "fused_glow_forward_1x1": 0, "fused_glow_inverse_1x1": 0,
        "fused_glow_backward_1x1": 0, "fused_glow_inverse_backward_1x1": 0,
        "reduce_weight_grads": 0}


def test_reduce_weight_grads_takes_plain_sum_on_cpu():
    partials = torch.from_numpy(
        np.random.RandomState(2).randn(5, 37).astype(np.float32))
    TK.reset_launch_counts()
    assert torch.equal(TK.reduce_weight_grads(partials), partials.sum(0))
    assert TK.launch_counts()["reduce_weight_grads"] == 0

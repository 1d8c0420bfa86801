"""The flow training kernels' plain versions and autograd Functions held
against the JAX package on the CPU: the windowed gather's gradient mode (K6
grads) against the Pallas kernel in interpret mode, the gradients of
``resample2d_region`` and ``splat_region`` against ``jax.grad`` of their
Pallas counterparts, and the fused INR backward (K7 backward, constant
mask) against ``jax.grad`` through ``fused_inr_apply`` in interpret mode.

All fp32 (``torch.backends.cuda.matmul.allow_tf32`` plays no part on the
CPU). Tolerances: 1e-5 absolute for the gather and splat gradients (the
same few taps summed in another order); 1e-5 normwise for the INR
gradients in fp32 (sums over a few hundred rows in another order); 2e-2
normwise for the bf16 operand mode (bf16 roundings land on either side of
a tie in the two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import FlowConfig as JaxFlowConfig
from sin_inn_tpu.models import inr as JI
from sin_inn_tpu.ops.pallas import gather as JG
from sin_inn_tpu.ops.pallas import inr as JPI
from sin_inn_tpu.ops.pallas import splat as JPS
from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.models import inr as TI
from sin_inn_tpu_torch.models.convert import inr_params_from_jax
from sin_inn_tpu_torch.ops.cuda import gather as TG
from sin_inn_tpu_torch.ops.cuda import inr as TK7
from sin_inn_tpu_torch.ops.cuda import splat as TK5
from torch_port_helpers import one_torch_thread  # noqa: F401


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _smooth_flow(rng, n, h, w, amp):
    ys = np.linspace(0, 1, h)[None, :, None]
    xs = np.linspace(0, 1, w)[None, None, :]
    ph = rng.uniform(0, 2 * np.pi, (n, 4, 1, 1))
    fx = amp * np.sin(2 * np.pi * xs + ph[:, 0]) * np.cos(np.pi * ys + ph[:, 1])
    fy = amp * np.cos(2 * np.pi * ys + ph[:, 2]) * np.sin(np.pi * xs + ph[:, 3])
    return np.stack([fx, fy], -1).astype(np.float32)


FLOWS = {"in_window": 5.0, "beyond_window": 20.0, "zero": 0.0}


# ---------------------------------------------------------------------------
# K6 grads: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flow_kind", sorted(FLOWS))
@pytest.mark.parametrize("coord_kind,c", [("resample", 3), ("raw", 5)])
def test_gather_grads_plain_matches_pallas(coord_kind, c, flow_kind):
    rng = np.random.RandomState(3)
    n, h, w = 1, 40, 64
    a = rng.rand(n, h, w, c).astype(np.float32)
    q = rng.randn(n, h, w, c).astype(np.float32)
    fl = _smooth_flow(rng, n, h, w, FLOWS[flow_kind])
    coord = JG._resample_coord(h, w) if coord_kind == "resample" else JG._RAW
    ref = JG._gather_region_call(jnp.asarray(a), jnp.asarray(fl),
                                 jnp.asarray(q), 8, 8, coord, True, True)
    got = TG.gather_region_grads_plain(_t(a), _t(fl), _t(q), 8, 8, coord)
    for g, r, name in zip(got, ref, ("out", "dfx", "dfy")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   err_msg=name)
    if flow_kind == "zero" and coord_kind == "raw":
        # every tap distance is 0 or 1: the derivative hat is 0 at both
        assert not got[1].any() and not got[2].any()
        assert torch.equal(got[0], _t(a))
    if flow_kind == "beyond_window":
        exact = TG.gather_region_grads_plain(_t(a), _t(fl), _t(q), 64, 64,
                                             coord)
        assert (exact[0] - got[0]).abs().max() > 0.1    # the window dropped taps


def test_gather_grads_wrapper_routes_and_checks():
    a = torch.rand(1, 8, 8, 3)
    fl = torch.zeros(1, 8, 8, 2)
    out, dfx, dfy = TG.gather_region_grads(a, fl, a, 8, 8, TG.RAW)
    assert out.shape == a.shape and dfx.shape == dfy.shape == (1, 8, 8)
    with pytest.raises(ValueError, match="payload"):
        TG.gather_region_grads(a, fl, a[..., :2], 8, 8, TG.RAW)
    with pytest.raises(TypeError):
        TG.gather_region_grads(a.double(), fl.double(), a.double(), 8, 8,
                               TG.RAW)
    assert TG.launch_counts()["gather_region_grads"] == 0    # CPU: plain


# ---------------------------------------------------------------------------
# The Functions: gradients against jax.grad of the Pallas wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flow_kind", sorted(FLOWS))
def test_resample2d_region_gradients_match_jax(flow_kind):
    rng = np.random.RandomState(5)
    n, h, w = 2, 24, 40
    img = rng.rand(n, h, w, 3).astype(np.float32)
    fl = _smooth_flow(rng, n, h, w, FLOWS[flow_kind])
    wgt = rng.randn(n, h, w, 3).astype(np.float32)

    def jloss(im, f):
        return jnp.sum(JG.resample2d_region(8, 8, True, im, f)
                       * jnp.asarray(wgt))

    j_img, j_fl = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(img),
                                                  jnp.asarray(fl))
    t_img, t_fl = _t(img).requires_grad_(), _t(fl).requires_grad_()
    (TG.resample2d_region(t_img, t_fl, 8, 8) * _t(wgt)).sum().backward()
    np.testing.assert_allclose(t_fl.grad.numpy(), np.asarray(j_fl),
                               atol=1e-5)
    # the image-gradient branch: the splat of the cotangent
    np.testing.assert_allclose(t_img.grad.numpy(), np.asarray(j_img),
                               atol=1e-5)


def test_resample2d_region_skips_the_image_gradient(monkeypatch):
    """Frames need no gradient in training: the backward then runs no
    splat."""
    calls = []
    real = TK5.splat_forward
    monkeypatch.setattr(TK5, "splat_forward",
                        lambda *a: calls.append(1) or real(*a))
    img = torch.rand(1, 24, 40, 3)
    fl = torch.zeros(1, 24, 40, 2, requires_grad=True)
    TG.resample2d_region(img, fl, 8, 8).sum().backward()
    assert not calls and fl.grad is not None
    img.requires_grad_()
    TG.resample2d_region(img, fl, 8, 8).sum().backward()
    assert calls == [1]


@pytest.mark.parametrize("flow_kind", sorted(FLOWS))
def test_splat_region_gradients_match_jax(flow_kind):
    rng = np.random.RandomState(7)
    n, h, w = 2, 24, 40
    v = rng.rand(n, h, w, 5).astype(np.float32)
    fl = _smooth_flow(rng, n, h, w, FLOWS[flow_kind])
    wgt = rng.randn(n, h, w, 5).astype(np.float32)

    def jloss(vals, f):
        return jnp.sum(JPS.splat_region(8, 8, True, vals, f)
                       * jnp.asarray(wgt))

    j_v, j_fl = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(v),
                                                jnp.asarray(fl))
    t_v, t_fl = _t(v).requires_grad_(), _t(fl).requires_grad_()
    (TK5.splat_region(t_v, t_fl, 8, 8) * _t(wgt)).sum().backward()
    np.testing.assert_allclose(t_v.grad.numpy(), np.asarray(j_v), atol=1e-5)
    np.testing.assert_allclose(t_fl.grad.numpy(), np.asarray(j_fl),
                               atol=1e-5)


def test_softsplat_region_with_coverage_gradients_match_jax():
    rng = np.random.RandomState(9)
    n, h, w = 1, 24, 40
    img = rng.rand(n, h, w, 3).astype(np.float32)
    fl = _smooth_flow(rng, n, h, w, 4.0)
    metric = -rng.rand(n, h, w, 1).astype(np.float32)

    def jloss(f, m):
        soft, _ = JPS.softsplat_region_with_coverage(
            jnp.asarray(img), f, m, 8, 8, interpret=True)
        return jnp.sum(soft ** 2)

    j_fl, j_m = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(fl),
                                                jnp.asarray(metric))
    t_fl, t_m = _t(fl).requires_grad_(), _t(metric).requires_grad_()
    soft, cover = TK5.softsplat_region_with_coverage(_t(img), t_fl, t_m, 8, 8)
    assert not cover.requires_grad
    (soft ** 2).sum().backward()
    # the normalisation by a small splatted weight gives gradients of tens:
    # relative 1e-5 beside the absolute 1e-5
    np.testing.assert_allclose(t_fl.grad.numpy(), np.asarray(j_fl),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_m.grad.numpy(), np.asarray(j_m),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K7 backward
# ---------------------------------------------------------------------------

WIDTHS = dict(num_frequencies=64, hidden_dim=128, num_layers=2)


def _nets(net, compute_dtype="float32", **kw):
    """The JAX net (the fused kernel forced on, interpret mode on the CPU)
    and the port's, with the same numpy weights."""
    widths = dict(WIDTHS, **kw)
    jcfg = JaxFlowConfig(use_pallas="on", compute_dtype=compute_dtype,
                         **widths)
    jspec, jp, jc = JI.build_inr(jax.random.PRNGKey(11), net, jcfg)
    tcfg = FlowConfig(device="cpu", compute_dtype=compute_dtype, **widths)
    tspec, _, _ = TI.build_inr(torch.Generator().manual_seed(0), net, tcfg)
    tp, tc = inr_params_from_jax(_np(jp), _np(jc))
    return (jspec, jp, jc), (tspec, tp, tc)


def _kind_enc_layers(tspec, tp, tc):
    kind = "rbf" if tspec.encoding == "rbf" else "ff"
    return kind, tc["enc"], [(l["w"], l["b"]) for l in tp["mlp"]]


def _normwise(got, ref):
    ref = np.asarray(ref)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _jax_grads(jspec, jp, jc, x, mask, tgt, precise):
    def loss(p):
        out = JPI.fused_inr_apply(jspec, p, jc, jnp.asarray(x),
                                  None if mask is None else jnp.asarray(mask),
                                  precise=precise, tn=128, interpret=True)
        return jnp.sum(out * jnp.asarray(tgt))

    return jax.grad(loss)(jp)["mlp"]


def _inputs_clear_of_the_gates(kind, enc, layers, e, n, masked):
    """Seeded (x, tgt, mask) for which no hidden pre-activation lies within
    1e-6 of 0: a relu gate that the two frameworks' sums put on either side
    of 0 changes whole rows of the gradients, which is no fault of either."""
    for seed in range(13, 64):
        rng = np.random.RandomState(seed)
        x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        tgt = rng.randn(n, 4).astype(np.float32)
        mask = rng.rand(e).astype(np.float32) if masked else None
        h = TK7.encode(kind, enc, _t(x),
                       torch.ones(e) if mask is None else _t(mask))
        clear = True
        for w, b in layers[:-1]:
            z = h @ w + b
            clear = clear and z.abs().min().item() > 1e-6
            h = torch.relu(z)
        if clear:
            return x, tgt, mask
    raise AssertionError("no seed keeps the pre-activations off 0")


@pytest.mark.parametrize("n", [384, 301])       # 301: not a tile multiple
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("net", ["RBF", "FFN", "UFF"])
def test_fused_inr_backward_matches_jax(net, masked, n):
    (jspec, jp, jc), (tspec, tp, tc) = _nets(net)
    kind, enc, layers = _kind_enc_layers(tspec, tp, tc)
    x, tgt, mask = _inputs_clear_of_the_gates(
        kind, enc, layers, tspec.encoding_dim, n, masked)
    ref = _jax_grads(jspec, jp, jc, x, mask, tgt, precise=True)

    tmask = torch.ones(tspec.encoding_dim) if mask is None else _t(mask)
    plain = TK7.fused_inr_backward_plain(kind, enc, layers, _t(x), tmask,
                                         _t(tgt))
    for (dw, db), r in zip(plain, ref):
        assert _normwise(dw.numpy(), r["w"]) < 1e-5
        assert _normwise(db.numpy(), r["b"]) < 1e-5

    # the Function, through inr_apply's routing
    for l in tp["mlp"]:
        l["w"].requires_grad_(), l["b"].requires_grad_()
    out = TI.inr_apply(tspec, tp, tc, _t(x),
                       mask=None if mask is None else _t(mask))
    assert type(out.grad_fn).__name__ == "FusedINRBackward"
    (out * _t(tgt)).sum().backward()
    for l, r in zip(tp["mlp"], ref):
        assert _normwise(l["w"].grad.numpy(), r["w"]) < 1e-5
        assert _normwise(l["b"].grad.numpy(), r["b"]) < 1e-5


def test_fused_inr_forward_matches_jax_and_keeps_no_activation():
    (jspec, jp, jc), (tspec, tp, tc) = _nets("RBF")
    x = np.random.RandomState(17).uniform(-1, 1, (200, 3)).astype(np.float32)
    ref = JPI.fused_inr_apply(jspec, jp, jc, jnp.asarray(x), None,
                              precise=True, tn=128, interpret=True)
    for l in tp["mlp"]:
        l["w"].requires_grad_()
    out = TI.inr_apply(tspec, tp, tc, _t(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    # saved for the backward: the points, the mask and the leaves only
    saved = out.grad_fn.saved_tensors
    assert max(t.numel() for t in saved) <= max(
        x.size, max(l["w"].numel() for l in tp["mlp"]))


@pytest.mark.parametrize("net", ["RBF", "FFN"])
def test_fused_inr_backward_bf16_operands_match_jax(net):
    (jspec, jp, jc), (tspec, tp, tc) = _nets(net, "bfloat16")
    rng = np.random.RandomState(19)
    x = rng.uniform(-1, 1, (384, 3)).astype(np.float32)
    # a cotangent with a mean: with a zero-mean one the sums cancel and the
    # comparison measures where the two frameworks break bf16 ties
    tgt = (0.5 + rng.rand(384, 4)).astype(np.float32)
    ref = _jax_grads(jspec, jp, jc, x, None, tgt, precise=False)
    for l in tp["mlp"]:
        l["w"].requires_grad_(), l["b"].requires_grad_()
    out = TI.inr_apply(tspec, tp, tc, _t(x))
    assert type(out.grad_fn).__name__ == "FusedINRBackward"
    (out * _t(tgt)).sum().backward()
    for l, r in zip(tp["mlp"], ref):
        assert _normwise(l["w"].grad.numpy(), r["w"]) < 2e-2
        assert _normwise(l["b"].grad.numpy(), r["b"]) < 2e-2
    # and the forward: bf16 operands, fp32 accumulation
    fwd = JPI.fused_inr_apply(jspec, jp, jc, jnp.asarray(x), None,
                              precise=False, tn=128, interpret=True)
    assert _normwise(out.detach().numpy(), fwd) < 2e-2


def test_fused_inr_routing():
    """The cases of the JAX package's eligibility test, and the switches."""
    (_, _, _), (spec, tp, tc) = _nets("RBF")
    x = torch.rand(64, 3) * 2 - 1
    assert TI.fused_inr_supported(spec, tp, tc, x, None)
    assert TI.fused_inr_supported(spec, tp, tc, x,
                                  torch.ones(spec.encoding_dim))
    # per-point masks, strict fp32, trainable encodings, 3-D points
    assert not TI.fused_inr_supported(spec, tp, tc, x,
                                      torch.ones(64, spec.encoding_dim))
    strict = dataclasses.replace(spec, compute_dtype="float32_highest")
    assert not TI.fused_inr_supported(strict, tp, tc, x, None)
    cfg = FlowConfig(device="cpu", **WIDTHS)
    gen = torch.Generator().manual_seed(1)
    s3, p3, c3 = TI.build_inr(gen, "RFF", cfg)
    assert not TI.fused_inr_supported(s3, p3, c3, x, None)
    assert not TI.fused_inr_supported(spec, tp, tc, x[None], None)
    s4, p4, c4 = TI.build_inr(gen, "siren", cfg)
    assert not TI.fused_inr_supported(s4, p4, c4, x, None)
    # the lane rule of the TPU kernel is gone: a hidden width of 96 is fine
    s5, p5, c5 = TI.build_inr(gen, "RBF", cfg.replace(hidden_dim=96))
    assert TI.fused_inr_supported(s5, p5, c5, x, None)
    # what the CUDA kernel needs, whatever the device of this test
    assert TK7.kernel_supports(4, 3, 512, 256, 4)
    assert not TK7.kernel_supports(4, 3, 510, 256, 4)      # E % 4
    assert not TK7.kernel_supports(4, 3, 512, 250, 4)      # H % 4
    assert not TK7.kernel_supports(4, 3, 1024, 512, 4)     # shared memory
    assert not TK7.kernel_supports(1, 3, 512, 256, 4)      # no hidden layer
    # the model does not ask those: a net of the right structure and the
    # wrong widths is eligible, and the wrapper refuses it on the card by
    # name instead of handing it to autograd (the CPU's plain version takes
    # any width, so here the check is called as the CUDA branch calls it)
    s6, p6, c6 = TI.build_inr(gen, "RBF", cfg.replace(hidden_dim=18))
    assert TI.fused_inr_supported(s6, p6, c6, x, None)
    l6 = [(l["w"], l["b"]) for l in p6["mlp"]]
    with pytest.raises(ValueError, match="multiples of 4.*use-kernel off"):
        TK7.require_kernel(l6, x)
    assert TK7.require_kernel(
        [(l["w"], l["b"]) for l in tp["mlp"]], x)[1:] == (
            3, spec.encoding_dim, spec.hidden_dim, spec.output_channels)
    wide = ([(torch.zeros(512, 512), torch.zeros(512))] * 3
            + [(torch.zeros(512, 4), torch.zeros(4))])
    with pytest.raises(ValueError, match="needs 262656"):
        TK7.require_kernel(wide, x)

    for l in tp["mlp"]:
        l["w"].requires_grad_()
    fused = TI.inr_apply(spec, tp, tc, x)
    assert type(fused.grad_fn).__name__ == "FusedINRBackward"
    off = TI.inr_apply(dataclasses.replace(spec, use_kernel="off"), tp, tc, x)
    assert off.requires_grad
    assert type(off.grad_fn).__name__ != "FusedINRBackward"
    np.testing.assert_allclose(fused.detach().numpy(), off.detach().numpy(),
                               atol=1e-6)
    with torch.no_grad():
        served = TI.inr_apply(spec, tp, tc, x)
    assert served.grad_fn is None
    assert torch.equal(served, off.detach())
    assert TK7.launch_counts() == {"fused_inr_forward": 0,
                                   "fused_inr_backward": 0}     # CPU: plain
    assert FlowConfig().use_kernel == "auto"
    with pytest.raises(ValueError, match="use_kernel"):
        FlowConfig(use_kernel="on")


def test_fused_inr_backward_refuses_what_it_cannot_take():
    (_, _, _), (spec, tp, tc) = _nets("RBF")
    kind, enc, layers = _kind_enc_layers(spec, tp, tc)
    x = torch.rand(16, 3)
    mask = torch.ones(spec.encoding_dim)
    g = torch.rand(16, 4)
    with pytest.raises(ValueError, match="kind"):
        TK7.fused_inr_backward("pe", enc, layers, x, mask, g)
    with pytest.raises(ValueError, match="mask"):
        TK7.fused_inr_backward(kind, enc, layers, x, mask[:-1], g)
    with pytest.raises(ValueError, match="cotangent"):
        TK7.fused_inr_backward(kind, enc, layers, x, mask, g[:, :2])
    with pytest.raises(ValueError, match="hidden layer"):
        TK7._dims(layers[:1], x)

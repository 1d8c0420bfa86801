"""The port's flow ops held against the JAX package on the CPU: encodings,
the INR, the exact warps and splats, the occlusions, the plain versions of
the windowed gather (K6) and splat (K5) against the Pallas kernels in
interpret mode, and the window-bound resolution.

Tolerances: 1e-5 absolute for fp32 elementwise chains that round alike;
2e-6 for the splats of values in [0, 1) (a few taps summed in another
order); 1e-4 for INR outputs (fp32 products over 128-256 wide layers summed
in another order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import FlowConfig as JaxFlowConfig
from sin_inn_tpu.models import inr as JI
from sin_inn_tpu.ops import encodings as JE
from sin_inn_tpu.ops import occlusion as JO
from sin_inn_tpu.ops import splat as JS
from sin_inn_tpu.ops import warp as JW
from sin_inn_tpu.ops.pallas import gather as JG
from sin_inn_tpu.ops.pallas import splat as JPS
from sin_inn_tpu.train import loop as JL
from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.models import inr as TI
from sin_inn_tpu_torch.models.convert import inr_params_from_jax
from sin_inn_tpu_torch.ops import encodings as TE
from sin_inn_tpu_torch.ops import occlusion as TO
from sin_inn_tpu_torch.ops import splat as TS
from sin_inn_tpu_torch.ops import warp as TW
from sin_inn_tpu_torch.ops.cuda import gather as TG
from sin_inn_tpu_torch.ops.cuda import splat as TK5
from sin_inn_tpu_torch.train import flow as TF
from sin_inn_tpu_torch.train import loop as TL
from torch_port_helpers import one_torch_thread  # noqa: F401


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _smooth_flow(rng, n, h, w, amp):
    """A smooth seeded flow field (N, H, W, 2) of amplitude ``amp`` px."""
    ys = np.linspace(0, 1, h)[None, :, None]
    xs = np.linspace(0, 1, w)[None, None, :]
    ph = rng.uniform(0, 2 * np.pi, (n, 4, 1, 1))
    fx = amp * np.sin(2 * np.pi * xs + ph[:, 0]) * np.cos(np.pi * ys + ph[:, 1])
    fy = amp * np.cos(2 * np.pi * ys + ph[:, 2]) * np.sin(np.pi * xs + ph[:, 3])
    return np.stack([fx, fy], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# Encodings and the INR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(JE.ENCODINGS))
def test_encoding_matches_jax(kind):
    init, apply = JE.ENCODINGS[kind]
    if kind == "positional":
        params, consts = init(jax.random.key(3), 3, 4)
    else:
        # Fourier phases of std 25 reach hundreds of radians, where one
        # fp32 rounding of the phase moves sin by ~3e-5: a narrower
        # spectrum keeps the comparison at the formula
        std = 12.0 if kind.startswith("rbf") else 4.0
        params, consts = init(jax.random.key(3), 3, 32, std)
    x = np.random.RandomState(0).uniform(-1, 1, (300, 3)).astype(np.float32)
    ref = np.asarray(apply(params, consts, jnp.asarray(x)))
    tp, tc = inr_params_from_jax(_np(params), _np(consts))
    got = TE.ENCODINGS[kind][1](tp, tc, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_port_encoding_inits_draw_the_reference_shapes():
    gen = torch.Generator().manual_seed(0)
    for kind, (init, _) in TE.ENCODINGS.items():
        args = (3, 4) if kind == "positional" else (3, 16, 10.0)
        p, c = init(gen, *args)
        jp, jc = JE.ENCODINGS[kind][0](jax.random.key(0), *args)
        for mine, ref in ((p, jp), (c, jc)):
            assert set(mine) == set(ref)
            for k in ref:
                assert tuple(mine[k].shape) == tuple(np.shape(ref[k])), k
    _, c = TE.rbf_init(gen, 3, 16, 12.0)
    assert torch.all(c["sigma"][1:] >= c["sigma"][:-1])


@pytest.mark.parametrize("net,hidden", [("RBF", 128), ("RBF", 16),
                                        ("FFN", 128), ("siren", 32),
                                        ("base", 32)])
def test_inr_apply_matches_jax(net, hidden):
    """hidden 128 (a 128-multiple): JAX's fused-INR gate takes
    ``_xla_forward``; hidden 16: its plain branch. Both agree with the
    port's one plain route."""
    jcfg = JaxFlowConfig(num_frequencies=64, hidden_dim=hidden,
                         use_pallas="on")
    spec, params, consts = JI.build_inr(jax.random.key(1), net, jcfg)
    x = np.random.RandomState(2).uniform(-1, 1, (500, 3)).astype(np.float32)
    ref = np.asarray(JI.inr_apply(spec, params, consts, jnp.asarray(x)))
    tcfg = FlowConfig(num_frequencies=64, hidden_dim=hidden, device="cpu")
    tspec, _, _ = TI.build_inr(torch.Generator().manual_seed(0), net, tcfg)
    tp, tc = inr_params_from_jax(_np(params), _np(consts))
    got = TI.inr_apply(tspec, tp, tc, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_build_inr_matches_jax_shapes_and_refuses_progressive():
    """(The name is from when the progressive nets were refused: they are
    built now, with the JAX package's shapes.)"""
    cfg = FlowConfig(device="cpu")
    spec, params, consts = TI.build_inr(torch.Generator().manual_seed(0),
                                        "RBF", cfg)
    jspec, jparams, jconsts = JI.build_inr(jax.random.key(0), "RBF",
                                           JaxFlowConfig())
    assert spec.encoding_dim == jspec.encoding_dim == 512
    assert [tuple(l["w"].shape) for l in params["mlp"]] == \
        [tuple(l["w"].shape) for l in jparams["mlp"]]
    assert tuple(consts["enc"]["centres"].shape) == (512, 3)
    for name in ("PRBF", "MPFF", "PFF"):
        pspec, pparams, _ = TI.build_inr(torch.Generator(), name, cfg)
        jpspec, jpparams, _ = JI.build_inr(jax.random.key(0), name,
                                           JaxFlowConfig())
        assert pspec.is_progressive and pspec.encoding_dim == 515 \
            == jpspec.encoding_dim
        assert [tuple(l["w"].shape) for l in pparams["mlp"]] == \
            [tuple(l["w"].shape) for l in jpparams["mlp"]]
    with pytest.raises(ValueError, match="unknown INR model"):
        TI.build_inr(torch.Generator(), "PXX", cfg)


# ---------------------------------------------------------------------------
# Exact warps, splats and occlusions
# ---------------------------------------------------------------------------

@pytest.fixture
def flows():
    rng = np.random.RandomState(4)
    img = rng.rand(2, 14, 18, 3).astype(np.float32)
    f1 = (rng.rand(2, 14, 18, 2) * 8 - 4).astype(np.float32)
    f2 = (rng.rand(2, 14, 18, 2) * 8 - 4).astype(np.float32)
    metric = -rng.rand(2, 14, 18, 1).astype(np.float32)
    return img, f1, f2, metric


@pytest.mark.parametrize("op", ["resample2d", "flow_warp_border",
                                "flow_warp_zeros", "grid_sample_ac",
                                "splat_scatter"])
def test_warp_and_scatter_match_jax(flows, op):
    img, f1, _, _ = flows
    j, t = jnp.asarray, torch.from_numpy
    if op == "resample2d":
        ref, got = JW.resample2d(j(img), j(f1)), TW.resample2d(t(img), t(f1))
    elif op.startswith("flow_warp"):
        pad = op.rsplit("_", 1)[1]
        ref = JW.flow_warp(j(img), j(f1), pad)
        got = TW.flow_warp(t(img), t(f1), pad)
    elif op == "grid_sample_ac":
        grid = f1 / 4.0
        ref = JW.grid_sample(j(img), j(grid), True, "border")
        got = TW.grid_sample(t(img), t(grid), True, "border")
    else:
        ref, got = JS.splat_scatter(j(img), j(f1)), TS.splat_scatter(t(img),
                                                                     t(f1))
    atol = 2e-6 if op == "splat_scatter" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("mode", ["summation", "average", "linear",
                                  "softmax"])
def test_softsplat_matches_jax(flows, mode):
    img, f1, _, metric = flows
    ref = JS.softsplat(jnp.asarray(img), jnp.asarray(f1), jnp.asarray(metric),
                       mode)
    got = TS.softsplat(_t(img), _t(f1), _t(metric), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_softsplat_with_coverage_matches_jax(flows):
    img, f1, _, metric = flows
    ref = JS.softsplat_with_coverage(jnp.asarray(img), jnp.asarray(f1),
                                     jnp.asarray(metric))
    got = TS.softsplat_with_coverage(_t(img), _t(f1), _t(metric))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("kind", ["wang", "brox", "unity"])
def test_occlusions_match_jax(flows, kind):
    _, f1, f2, _ = flows
    ref = JO.OCCLUSIONS[kind](jnp.asarray(f1), jnp.asarray(f2), 0.7)
    got = TO.OCCLUSIONS[kind](_t(f1), _t(f2), 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# K6 and K5: plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

# (shape, flow amplitude px): in-window flows, and flows that leave the
# 8-px window over a two-by-three-tile frame
CASES = [((2, 40, 50), 5.0), ((1, 200, 300), 20.0)]


@pytest.mark.parametrize("shape,amp", CASES)
@pytest.mark.parametrize("coord", ["resample", "raw"])
def test_gather_plain_matches_pallas_kernel(shape, amp, coord):
    rng = np.random.RandomState(5)
    n, h, w = shape
    a = rng.rand(n, h, w, 3).astype(np.float32)
    fl = _smooth_flow(rng, n, h, w, amp)
    cd = JG._resample_coord(h, w) if coord == "resample" else JG._RAW
    ref = np.asarray(JG._gather_region_call(jnp.asarray(a), jnp.asarray(fl),
                                            None, 8, 8, cd, False, True))
    got = TG.gather_region(_t(a), _t(fl), 8, 8, cd).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    if amp > 8:   # the drop rule is exercised: the exact warp differs
        exact = TW.resample2d(_t(a), _t(fl)).numpy()
        assert np.abs(exact - got).max() > 1e-2 or coord == "raw"


def test_resample2d_region_matches_jax():
    rng = np.random.RandomState(6)
    img = rng.rand(2, 40, 50, 3).astype(np.float32)
    fl = _smooth_flow(rng, 2, 40, 50, 5.0)
    ref = np.asarray(JG.resample2d_region(8, 8, True, jnp.asarray(img),
                                          jnp.asarray(fl)))
    got = TG.resample2d_region(_t(img), _t(fl), 8, 8).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # in-window flows: the exact warp (coordinate rounding differs)
    exact = TW.resample2d(_t(img), _t(fl)).numpy()
    np.testing.assert_allclose(got, exact, atol=2e-4)


@pytest.mark.parametrize("shape,amp", CASES)
def test_splat_plain_matches_pallas_kernel(shape, amp):
    rng = np.random.RandomState(7)
    n, h, w = shape
    v = rng.rand(n, h, w, 5).astype(np.float32)
    fl = _smooth_flow(rng, n, h, w, amp)
    ref = np.asarray(JPS._splat_region_call(jnp.asarray(v), jnp.asarray(fl),
                                            8, 8, True))
    got = TK5.splat_region(_t(v), _t(fl), 8, 8).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6)
    exact = TS.splat_scatter(_t(v), _t(fl)).numpy()
    if amp < 8:
        np.testing.assert_allclose(got, exact, atol=2e-6)
    else:
        assert np.abs(exact - got).max() > 1e-2


def test_softsplat_region_with_coverage_matches_jax():
    rng = np.random.RandomState(8)
    img = rng.rand(2, 30, 40, 3).astype(np.float32)
    fl = _smooth_flow(rng, 2, 30, 40, 4.0)
    metric = -rng.rand(2, 30, 40, 1).astype(np.float32)
    ref = JPS.softsplat_region_with_coverage(
        jnp.asarray(img), jnp.asarray(fl), jnp.asarray(metric), 6, 6,
        interpret=True)
    got = TK5.softsplat_region_with_coverage(_t(img), _t(fl), _t(metric),
                                             6, 6)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_region_wrappers_refuse_what_they_cannot_do():
    v = torch.rand(1, 8, 8, 3)
    fl = torch.zeros(1, 8, 8, 2)
    with pytest.raises(ValueError, match="bounds"):
        TK5.splat_region(v, fl, -1, 8)
    # both wrappers are differentiable: the gradients of sum(out) in the
    # values / the image at zero flow are ones (the splat and the warp at
    # resample coordinates both move nothing farther than a pixel)
    fl.requires_grad_()
    TK5.splat_region(v.requires_grad_(), fl, 8, 8).sum().backward()
    assert torch.equal(v.grad, torch.ones_like(v))
    assert fl.grad is not None and not fl.grad.any()   # dhat(0) = 0
    v.grad = None
    TG.resample2d_region(v, fl, 8, 8).square().sum().backward()
    assert v.grad.abs().sum() > 0 and torch.isfinite(fl.grad).all()
    fl = fl.detach()
    with pytest.raises(TypeError):
        TK5.splat_region(v.detach().double(), fl.double(), 8, 8)
    with pytest.raises(ValueError):
        TG.resample2d_region(v.detach(), fl[..., :1], 8, 8)
    assert TG.launch_counts() == {"gather_region": 0,
                                  "gather_region_grads": 0,
                                  "gather_region_local": 0,
                                  "gather_region_local_grads": 0}
    assert TK5.launch_counts() == {"splat_region": 0,
                                   "splat_region_local": 0}


# ---------------------------------------------------------------------------
# Window bounds and routing
# ---------------------------------------------------------------------------

BOUNDS = [dict(), dict(splat_max_dy="off"), dict(splat_max_dy=32),
          dict(splat_max_dx=64), dict(splat_max_dy=48, splat_max_dx="off"),
          dict(splat_max_dy=0), dict(splat_max_dy=None, splat_max_dx=None),
          dict(splat_max_dy=8, splat_max_dx=8),
          dict(splat_max_dy=16, splat_max_dx=200)]


@pytest.mark.parametrize("hw", [(436, 1024), (24, 40), (120, 300),
                                (200, 260)])
def test_resolve_splat_bounds_matches_jax(hw):
    for kw in BOUNDS:
        got = FlowConfig(**kw).resolve_splat_bounds(*hw)
        ref = JaxFlowConfig(**kw).resolve_splat_bounds(*hw)
        assert got.bounds_resolved
        for k in FlowConfig.WINDOW_BOUND_KEYS:
            assert getattr(got, k) == getattr(ref, k), (kw, k)
        assert got.resolve_splat_bounds(*hw) == got     # idempotent


def _sidecar(d, **bounds):
    with open(d / "window_bounds.json", "w") as f:
        json.dump({"fh": 436, "fw": 1024, "splat_max_dy": 48,
                   "splat_max_dx": 96, "splat_local_dx": None, **bounds,
                   "hist": {}}, f)


def test_window_sidecar_and_inference_bounds_match_jax(tmp_path):
    """A sidecar without local windows: the port's bounds are JAX's after
    its ``_inference_bounds``. With local windows: both engage them."""
    d = str(tmp_path)
    _sidecar(tmp_path, splat_local_dy=None)
    for kw, size in ((dict(), (436, 1024)), (dict(), (200, 300)),
                     (dict(splat_max_dy=16), (436, 1024)),
                     (dict(splat_max_dx="off"), (436, 1024))):
        got, found = TL._load_window_bounds(FlowConfig(**kw), d, *size)
        ref, jfound = JL._load_window_bounds(JaxFlowConfig(**kw), d, *size)
        assert found == jfound
        ri = JL._inference_bounds(ref)
        assert ri.splat_local_dy in (None, "off")
        got = TL._inference_bounds(got)
        for k in FlowConfig.WINDOW_BOUND_KEYS:
            assert getattr(got, k) == getattr(ri, k), (kw, k)
    assert TL._load_window_bounds(FlowConfig(), str(tmp_path / "none"),
                                  436, 1024)[1] is False

    _sidecar(tmp_path, splat_local_dy=24)
    ref, _ = JL._load_window_bounds(JaxFlowConfig(), d, 436, 1024)
    assert JL._inference_bounds(ref).splat_local_dy == 24
    got, found = TL._load_window_bounds(FlowConfig(), d, 436, 1024)
    assert found and TL._inference_bounds(got).splat_local_dy == 24
    # another frame size ignores the sidecar, in both
    assert TL._load_window_bounds(FlowConfig(), d, 200, 300)[1] is False


def test_splat_ops_routes():
    cpu = dict(device="cpu")
    warp, splat, local = TF._splat_ops(
        FlowConfig(**cpu).resolve_splat_bounds(24, 40))
    assert local is None
    img, fl = torch.rand(1, 24, 40, 3), torch.rand(1, 24, 40, 2)
    torch.testing.assert_close(warp(img, fl), TW.resample2d(img, fl))
    cfg = FlowConfig(splat_max_dy=8, splat_max_dx=8,
                     **cpu).resolve_splat_bounds(24, 40)
    warp, _, local = TF._splat_ops(cfg)
    assert local is None      # local 'auto' (8) is no narrower than dy 8
    torch.testing.assert_close(warp(img, fl), TG.resample2d_region(img, fl,
                                                                   8, 8))
    # Sintel size resolves to the local-window kernels at dy=64, dx=128,
    # local dy 32; with the local bound off, to the static ones
    sintel = FlowConfig(**cpu).resolve_splat_bounds(436, 1024)
    assert (sintel.splat_max_dy, sintel.splat_max_dx,
            sintel.splat_local_dy) == (64, 128, 32)
    warp, _, local = TF._splat_ops(sintel)
    assert local == (32, 128, 64, 0)
    offs = TF._flow_offsets(fl, local)
    torch.testing.assert_close(warp(img, fl, offs), TG.resample2d_region_local(
        img, fl, offs.off_src, 32, 128, 64, 0))
    warp, _, local = TF._splat_ops(sintel.replace(splat_local_dy=None))
    assert local is None
    torch.testing.assert_close(warp(img, fl), TG.resample2d_region(img, fl,
                                                                   64, 128))
    # the row-only window: the exact warp and the row-windowed splat
    rows = FlowConfig(splat_max_dy=16, splat_max_dx="off",
                      **cpu).resolve_splat_bounds(436, 1024)
    warp, splat, local = TF._splat_ops(rows)
    metric = -torch.rand(1, 24, 40, 1)
    torch.testing.assert_close(warp(img, fl), TW.resample2d(img, fl))
    torch.testing.assert_close(
        splat(img, fl, metric), TS.softsplat_windowed_with_coverage(
            img, fl, metric, 16, 2))
    with pytest.raises(ValueError):
        TF._splat_ops(FlowConfig(**cpu))
    with pytest.raises(ValueError):
        FlowConfig(splat_max_dy="on")
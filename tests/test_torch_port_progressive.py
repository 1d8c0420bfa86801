"""The progressive nets of the port held against the JAX package on the CPU:
``alpha_mask``, ``build_inr`` + ``inr_params_from_jax`` + ``inr_apply`` for
all seven, the fused route's plain versions (K7 forward and backward in the
``const`` + coordinate rows, ``slab`` and ``point`` modes) against the JAX
kernel in interpret mode and against JAX autodiff of its XLA route, and the
slice as a whole: ``flow_forward`` in the three mask formats, four train steps
under the linear and the spatial controller with converted parameters and
controller state, and the controller state through ``run_flow_train``'s
checkpoint.

All fp32 unless a test says bf16. Tolerances: 1e-5 for INR outputs (products
over at most 131 channels summed in another order; narrow Fourier spectra,
see ``_cfgs``); every gradient leaf within 1e-4 of its largest entry (sums
over about a thousand points in another order; the inputs keep every relu
pre-activation 1e-6 away from 0, where the two packages' sums could gate a
point differently); 2e-2 normwise in the bf16 operand mode (bf16 ties broken
at other places), as ``test_torch_port_inr_bwd.py``; 1e-5 relative for the
losses of the train steps and 1e-5 absolute for their parameters.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import FlowConfig as JaxFlowConfig
from sin_inn_tpu.models import controllers as JC
from sin_inn_tpu.models import inr as JI
from sin_inn_tpu.ops.pallas import inr as JPI
from sin_inn_tpu.train import flow as JF
from sin_inn_tpu_torch import cli
from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.data import flow_media as TM
from sin_inn_tpu_torch.data.synthetic import moving_texture_video
from sin_inn_tpu_torch.models import controllers as TC
from sin_inn_tpu_torch.models import inr as TI
from sin_inn_tpu_torch.models.convert import (ctrl_state_from_jax,
                                              inr_params_from_jax)
from sin_inn_tpu_torch.ops.cuda import inr as TK7
from sin_inn_tpu_torch.train import flow as TF
from sin_inn_tpu_torch.train import loop as TL
from torch_port_helpers import one_torch_thread  # noqa: F401

PROGRESSIVE = ("PFF", "PRBF", "PRBFG", "PPE", "PRFF", "PUFF", "MPFF")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cfgs(use="on", compute_dtype="float32", **kw):
    """The two packages' configs at a small size. std 4: a Fourier phase of
    std 25 reaches hundreds of radians, where one fp32 rounding of the phase
    moves the sine by 3e-5, which would measure the rounding and not the
    formula."""
    kw = dict(dict(num_frequencies=64, hidden_dim=128, num_layers=2, std=4.0),
              **kw)
    jcfg = JaxFlowConfig(use_pallas=use, compute_dtype=compute_dtype, **kw)
    tcfg = FlowConfig(device="cpu", compute_dtype=compute_dtype,
                      use_kernel="auto" if use == "on" else "off", **kw)
    return jcfg, tcfg


def _nets(net, seed=11, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jspec, jp, jc = JI.build_inr(jax.random.PRNGKey(seed), net, jcfg)
    tspec, fresh, _ = TI.build_inr(torch.Generator().manual_seed(0), net, tcfg)
    tp, tc = inr_params_from_jax(_np(jp), _np(jc))
    assert [tuple(l["w"].shape) for l in tp["mlp"]] == \
        [tuple(l["w"].shape) for l in fresh["mlp"]]
    return (jspec, jp, jc), (tspec, tp, tc)


# ---------------------------------------------------------------------------
# alpha_mask, build_inr, inr_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0, 0.05, 0.37, 0.5, 0.999, 1.0])
def test_alpha_mask_matches_jax(alpha):
    (jspec, _, _), (tspec, _, _) = _nets("PFF")
    np.testing.assert_array_equal(TI.alpha_mask(tspec, alpha).numpy(),
                                  np.asarray(JI.alpha_mask(jspec, alpha)))


@pytest.mark.parametrize("mask_kind", ["none", "vector", "dense", "alpha"])
@pytest.mark.parametrize("net", PROGRESSIVE)
def test_progressive_inr_apply_matches_jax(net, mask_kind):
    """The plain route (hidden 16 is no 128-multiple, so JAX takes XLA)."""
    (jspec, jp, jc), (tspec, tp, tc) = _nets(net, use="off", hidden_dim=16,
                                             num_frequencies=16)
    assert tspec.is_progressive and tspec.encoding_dim == \
        jspec.encoding_dim == tp["mlp"][0]["w"].shape[0]
    assert tspec.encoding_channels == tspec.encoding_dim - 3
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    e = tspec.encoding_dim
    mask = {"none": None, "alpha": None,
            "vector": rng.rand(e).astype(np.float32),
            "dense": rng.rand(300, e).astype(np.float32)}[mask_kind]
    alpha = 0.4 if mask_kind == "alpha" else None
    ref = JI.inr_apply(jspec, jp, jc, jnp.asarray(x),
                       None if mask is None else jnp.asarray(mask), alpha)
    with torch.no_grad():
        got = TI.inr_apply(tspec, tp, tc, _t(x),
                           None if mask is None else _t(mask), alpha)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    if mask_kind == "alpha":      # alpha = 1 and a non-progressive net: none
        full = TI.inr_apply(tspec, tp, tc, _t(x), alpha=1.0)
        assert torch.equal(full, TI.inr_apply(tspec, tp, tc, _t(x)))


# ---------------------------------------------------------------------------
# The fused route: plain versions of K7 forward and backward
# ---------------------------------------------------------------------------

B, H, W, RES = 2, 4, 128, 5


def _fused_setup(net, mode, compute_dtype="float32"):
    """Both packages' net, the pose grid, a seeded non-initial controller
    mask in the mode's format in each package, and its dense (n, E) form.
    The weights' seed is the first that keeps every hidden pre-activation
    1e-6 away from 0 (see the module docstring)."""
    times = np.array([-0.4, 0.8], np.float32)
    rng = np.random.RandomState(5)
    for seed in range(11, 40):
        (jspec, jp, jc), (tspec, tp, tc) = _nets(
            net, seed=seed, compute_dtype=compute_dtype)
        jccfg = JC.SpatialConfig.create(jspec, RES, 4)
        tccfg = TC.SpatialConfig.create(tspec, RES, 4)
        cells = rng.rand(jccfg.cells, jccfg.encoding_dim).astype(np.float32)
        jstate = JC.spatial_init(jccfg)._replace(mask=jnp.asarray(cells))
        tstate = TC.spatial_init(tccfg)._replace(mask=_t(cells))
        jt, tt = jnp.asarray(times), _t(times)
        pts = TF.pose_grid(tt, H, W).reshape(-1, 3)
        jdense = JC.spatial_grid_mask(jccfg, jstate, jt, H, W)
        perm = JPI.inr_mask_perm(jspec)
        if mode == "const":
            vec = rng.rand(jspec.encoding_dim).astype(np.float32)
            jmask, tmask = jnp.asarray(vec), _t(vec)
            jdense = jnp.broadcast_to(jmask, (B * H * W, vec.size))
        elif mode == "slab":
            jmask = tuple(JC.spatial_grid_mask_slabs(jccfg, jstate, jt, H, W,
                                                     enc_perm=perm))
            tmask = TC.spatial_grid_mask_slabs(tccfg, tstate, tt, H, W)
        else:
            jmask = JC.spatial_grid_mask_split(jccfg, jstate, jt, H, W,
                                               enc_perm=perm)
            tmask = TC.spatial_grid_mask_split(tccfg, tstate, tt, H, W)
        kind = "rbf" if tspec.encoding == "rbf" else "ff"
        layers = [(l["w"], l["b"]) for l in tp["mlp"]]
        net_ = TK7._resolve(kind, tc["enc"], layers, pts, tmask)
        acts, _ = TK7._recompute(kind, tc["enc"], net_, layers, pts, 0,
                                 pts.shape[0], False, True)
        pre = acts[1]       # relu output: a gate is clear if it is 0 or big
        if ((pre == 0) | (pre > 1e-6)).all():
            return dict(j=(jspec, jp, jc), t=(tspec, tp, tc), pts=pts,
                        jmask=jmask, tmask=tmask, jdense=jdense, kind=kind,
                        layers=layers)
    raise AssertionError("no seed keeps the pre-activations off 0")


def _leaf_close(got, ref, what):
    ref = np.asarray(ref)
    lim = 1e-4 * np.abs(ref).max()
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max() <= lim, \
        f"{what}: {np.abs(got - ref).max():.3e} > {lim:.3e}"


@pytest.mark.parametrize("mode", ["const", "slab", "point"])
@pytest.mark.parametrize("net", ["PFF", "PRBF"])
def test_fused_progressive_plain_versions_match_jax(net, mode):
    s = _fused_setup(net, mode)
    jspec, jp, jc = s["j"]
    tspec, tp, tc = s["t"]
    pts, jpts = s["pts"], jnp.asarray(s["pts"].numpy())
    tgt = np.random.RandomState(7).randn(pts.shape[0], 4).astype(np.float32)

    def fused(p):
        return JPI.fused_inr_apply(jspec, p, jc, jpts, s["jmask"],
                                   precise=True, tn=128, interpret=True)

    def xla(p):
        off = dataclasses.replace(jspec, use_pallas="off")
        return JI.inr_apply(off, p, jc, jpts, override_mask=s["jdense"])

    assert JPI.fused_inr_supported(jspec, jp, jc, jpts, s["jmask"])
    ref = np.asarray(fused(jp))
    enc = tc["enc"]
    out = TK7.fused_inr_forward_plain(s["kind"], enc, s["layers"], pts,
                                      s["tmask"])
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla(jp)), atol=1e-5)
    assert torch.equal(out, TK7.fused_inr_forward(s["kind"], enc, s["layers"],
                                                  pts, s["tmask"]))   # CPU

    g_fused = jax.grad(lambda p: jnp.sum(fused(p) * tgt))(jp)["mlp"]
    g_xla = jax.grad(lambda p: jnp.sum(xla(p) * tgt))(jp)["mlp"]
    plain = TK7.fused_inr_backward_plain(s["kind"], enc, s["layers"], pts,
                                         s["tmask"], _t(tgt))
    for l, ((dw, db), rf, rx) in enumerate(zip(plain, g_fused, g_xla)):
        for ref_g, name in ((rf, "kernel"), (rx, "autodiff")):
            _leaf_close(dw.numpy(), ref_g["w"], f"dW_{l} against JAX's {name}")
            _leaf_close(db.numpy(), ref_g["b"], f"db_{l} against JAX's {name}")
    # the coordinate rows lead dW_0 and carry a gradient of their own
    assert plain[0][0].shape[0] == tspec.encoding_dim
    assert plain[0][0][:3].abs().max() > 0

    # the Function, through inr_apply's routing
    assert TI.fused_inr_eligible(tspec, tp, tc, pts, s["tmask"])
    for l in tp["mlp"]:
        l["w"].requires_grad_(), l["b"].requires_grad_()
    res = TI.inr_apply(tspec, tp, tc, pts, mask=s["tmask"])
    assert type(res.grad_fn).__name__ == "FusedINRBackward"
    np.testing.assert_allclose(res.detach().numpy(), ref, atol=1e-5)
    # saved for the backward: points, mask operands, leaves; never (n, E)
    n_e = pts.shape[0] * tspec.encoding_channels
    if mode != "point":
        assert max(t.numel() for t in res.grad_fn.saved_tensors) < n_e
    (res * _t(tgt)).sum().backward()
    for l, (layer, rf) in enumerate(zip(tp["mlp"], g_fused)):
        _leaf_close(layer["w"].grad.numpy(), rf["w"], f"Function dW_{l}")
        _leaf_close(layer["b"].grad.numpy(), rf["b"], f"Function db_{l}")
    assert TK7.launch_counts() == {"fused_inr_forward": 0,
                                   "fused_inr_backward": 0}    # CPU: plain


@pytest.mark.parametrize("mode", ["const", "slab", "point"])
def test_fused_progressive_bf16_operands_match_jax(mode):
    """bf16 operand mode: the slabs (or the per-point mask) emitted in bf16,
    wx rounded in the rebuild, the encoding fp32."""
    s = _fused_setup("PFF", mode, "bfloat16")
    jspec, jp, jc = s["j"]
    tspec, tp, tc = s["t"]
    pts, jpts = s["pts"], jnp.asarray(s["pts"].numpy())
    tgt = (0.5 + np.random.RandomState(9).rand(pts.shape[0], 4)
           ).astype(np.float32)
    cast = (lambda m, d: m) if mode == "const" else (
        lambda m, d: tuple(t.astype(d) if hasattr(t, "astype") else t.to(d)
                           for t in m))
    jmask = cast(s["jmask"], jnp.bfloat16)
    tmask = cast(s["tmask"], torch.bfloat16)
    if mode == "slab":       # wx stays float32 until the rebuild rounds it
        jmask = jmask[:2] + (s["jmask"][2],)
        tmask = TC.SpatialSlabMask(tmask[0], tmask[1], s["tmask"].wx)

    def fused(p):
        return JPI.fused_inr_apply(jspec, p, jc, jpts, jmask, precise=False,
                                   tn=128, interpret=True)

    normwise = lambda a, r: (np.linalg.norm(a - np.asarray(r))
                             / np.linalg.norm(np.asarray(r)))
    out = TK7.fused_inr_forward_plain(s["kind"], tc["enc"], s["layers"], pts,
                                      tmask, bf16=True)
    assert normwise(out.numpy(), fused(jp)) < 2e-2
    ref = jax.grad(lambda p: jnp.sum(fused(p) * tgt))(jp)["mlp"]
    got = TK7.fused_inr_backward_plain(s["kind"], tc["enc"], s["layers"], pts,
                                       tmask, _t(tgt), bf16=True)
    for (dw, db), r in zip(got, ref):
        assert normwise(dw.numpy(), r["w"]) < 2e-2
        assert normwise(db.numpy(), r["b"]) < 2e-2


def test_fused_progressive_routing():
    """The tuple-mask cases of the JAX package's eligibility test, the
    port's tile rule, the shared gate, and the plain route's reassembly."""
    s = _fused_setup("PFF", "slab")
    tspec, tp, tc = s["t"]
    pts, slabs = s["pts"], s["tmask"]
    split = _fused_setup("PFF", "point")["tmask"]
    sup = lambda m, sp=tspec, x=pts: TI.fused_inr_supported(sp, tp, tc, x, m)
    assert sup(slabs) and sup(tuple(slabs)) and sup(split) and sup(None)
    assert sup(torch.ones(tspec.encoding_dim))
    assert not sup(TI.dense_mask(slabs))              # unsplit per-point mask
    assert not sup(slabs, x=pts[:-W])                 # rows x W != n
    assert not sup((split[0], split[1][:-1]))
    assert not sup((slabs.enc, slabs.coord, slabs.wx[:40]))    # W % 32
    assert not sup((slabs.enc[0], slabs.coord, slabs.wx))
    rbf = dataclasses.replace(tspec, is_progressive=False)
    assert not sup(slabs, sp=rbf) and not sup(split, sp=rbf)
    # the format follows the same gate as the dispatch
    fmt = lambda sp, w: TI.fused_spatial_mask_format(sp, tp, tc, pts, w)
    off = dataclasses.replace(tspec, use_kernel="off")
    assert (fmt(tspec, 1024), fmt(tspec, 128), fmt(tspec, 40),
            fmt(off, 1024)) == ("slabs", "slabs", "split", "dense")
    strict = dataclasses.replace(tspec, compute_dtype="float32_highest")
    assert fmt(strict, 1024) == "dense"
    assert not TI.fused_inr_eligible(off, tp, tc, pts, slabs)
    # what the kernels need beside the structure: the tile with xm and wx
    assert TK7.kernel_supports(4, 3, 512, 256, 4, prog=True, res=50)
    assert not TK7.kernel_supports(4, 3, 512, 256, 4, prog=True, res=600)
    assert TK7._smem_bytes(4, 512, 256, 4, True, 50) == 164352 + 512 + 6600
    # serving: the forward route under no_grad, the same numbers; off: dense
    with torch.no_grad():
        served = TI.inr_apply(tspec, tp, tc, pts, mask=slabs)
        dense = TI.inr_apply(off, tp, tc, pts, mask=slabs)
        joint = TI.inr_apply(off, tp, tc, pts, mask=TI.dense_mask(slabs))
    assert torch.equal(dense, joint)
    np.testing.assert_allclose(served.numpy(), dense.numpy(), atol=1e-5)
    for bad, what in (((slabs.enc, slabs.coord), "split mask"),
                      ((slabs.enc, slabs.coord, slabs.wx, slabs.wx),
                       "a mask is"),
                      ((slabs.enc, slabs.coord, slabs.wx[:40]), "row slabs")):
        with pytest.raises(ValueError, match=what):
            TK7.fused_inr_forward(s["kind"], tc["enc"], s["layers"], pts, bad)
    rbf_layers = [(s["layers"][0][0][3:], s["layers"][0][1])] + s["layers"][1:]
    with pytest.raises(ValueError, match="progressive"):
        TK7.fused_inr_forward(s["kind"], tc["enc"], rbf_layers, pts, slabs)
    with pytest.raises(ValueError, match="first layer"):
        TK7.fused_inr_forward(s["kind"], tc["enc"],
                              [(s["layers"][0][0][1:], s["layers"][0][1])]
                              + s["layers"][1:], pts, None)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

KW = dict(net="PFF", splat_max_dy=8, splat_max_dx=8, lr=1e-3, epochs=60,
          spatial_res=5)


def _paired(spatial, use="on", **kw):
    jcfg, tcfg = _cfgs(use, spatially_adaptive=spatial, **dict(KW, **kw))
    jcfg = jcfg.replace(splat_local_dy="off", splat_local_dx="off")
    jspec, jstate, jconsts, jccfg, tx = JF.create_flow_state(
        jax.random.PRNGKey(3), jcfg)
    tp, tc = inr_params_from_jax(_np(jstate.params), _np(jconsts))
    tspec, _, _, tccfg, fresh = TF.build_flow_model(
        torch.Generator().manual_seed(0), tcfg)
    for k, v in jccfg.__dict__.items():
        assert getattr(tccfg, k) == v, k
    tctrl = ctrl_state_from_jax(_np(jstate.ctrl_state))
    assert type(tctrl) is type(fresh) and type(tctrl).__name__ == (
        "SpatialState" if spatial else "LinearState")
    tstate = TF.train_state(tp, tcfg, ctrl_cfg=tccfg, ctrl_state=tctrl)
    return (jcfg, jspec, jstate, jconsts, jccfg, tx), (tcfg, tspec, tstate, tc)


@pytest.mark.parametrize("use,w,fmt", [("on", 128, "slabs"),
                                       ("on", 40, "split"),
                                       ("off", 128, "dense")])
def test_flow_forward_matches_jax_in_every_mask_format(use, w, fmt):
    """The spatial controller's mask reaches the INR as row slabs, as the
    split pair (a width that is no multiple of the tile: JAX takes XLA
    there, the port the point mode) or dense (``use_kernel="off"``)."""
    (jcfg, jspec, jstate, jconsts, jccfg, _), (tcfg, tspec, tstate, tc) = \
        _paired(True, use)
    rng = np.random.RandomState(4)
    cells = rng.rand(jccfg.cells, jccfg.encoding_dim).astype(np.float32)
    jctrl = jstate.ctrl_state._replace(mask=jnp.asarray(cells))
    tctrl = tstate.ctrl_state._replace(mask=_t(cells))
    times = np.array([-1.0, 0.25], np.float32)
    j12, j21, _ = JF.flow_forward(jspec, jstate.params, jconsts, jccfg, jctrl,
                                  jnp.asarray(times), 6, w, jnp.float32(8.0))
    pts = TF.pose_grid(_t(times), 6, w).reshape(-1, 3)
    assert TI.fused_spatial_mask_format(tspec, tstate.params, tc, pts,
                                        w) == fmt
    mask, _ = TF.controller_mask(tspec, tstate.params, tc, tstate.ctrl_cfg,
                                 tctrl, _t(times), 6, w, pts)
    assert {"slabs": 3, "split": 2}.get(fmt) == (
        len(mask) if isinstance(mask, tuple) else None)
    t12, t21 = TF.flow_forward(tspec, tstate.params, tc, _t(times), 6, w, 8.0,
                               tstate.ctrl_cfg, tctrl)
    assert t12.requires_grad
    assert (type(t12.grad_fn.next_functions[0][0]).__name__ != "x") \
        and t12.shape == (2, 6, w, 2)
    np.testing.assert_allclose(t12.detach().numpy(), np.asarray(j12),
                               atol=1e-4)       # flows in px: 8 x 1e-5
    np.testing.assert_allclose(t21.detach().numpy(), np.asarray(j21),
                               atol=1e-4)
    i12, _ = TF.flow_infer(tspec, tstate.params, tc, _t(times), 8.0, 6, w,
                           tstate.ctrl_cfg, tctrl)
    np.testing.assert_allclose(i12.numpy(), t12.detach().numpy(), atol=1e-5)


@pytest.mark.parametrize("spatial", [False, True], ids=["linear", "spatial"])
def test_four_progressive_train_steps_match_jax(spatial):
    """The slice end to end: the controller's mask, the INR (the plain K7
    versions here, the Pallas kernels in interpret mode there), warps,
    splats, losses, LAMB and the controller's transition; block_iterations
    is 2, so the block advances twice."""
    (jcfg, jspec, jstate, jconsts, jccfg, tx), (tcfg, tspec, tstate, tc) = \
        _paired(spatial)
    assert tstate.ctrl_cfg.block_iterations == 2
    jstep = JF.make_flow_train_step(jspec, jcfg, jccfg, tx)
    tstep = TF.make_flow_train_step(tspec, tcfg)
    vid = moving_texture_video(5, 16, 128, seed=1)
    times = np.linspace(-1, 1, 5).astype(np.float32)
    first_mask = tstate.ctrl_state.mask.clone()
    for i in range(4):
        b = {"frame1": vid[i:i + 1], "frame2": vid[i + 1:i + 2],
             "times": times[i:i + 1], "scale": np.float32(8.0)}
        jstate, jm = jstep(jstate, jconsts,
                           {k: jnp.asarray(v) for k, v in b.items()})
        tm = tstep(tstate, tc, {k: (float(v) if k == "scale"
                                    else torch.as_tensor(v))
                                for k, v in b.items()})
        assert set(tm) == set(jm)
        assert abs(tm["loss"].item() - float(jm["loss"])) \
            < 1e-5 * abs(float(jm["loss"]))
        ref = ctrl_state_from_jax(_np(jstate.ctrl_state))
        for name in ref._fields:
            got, want = getattr(tstate.ctrl_state, name), getattr(ref, name)
            if isinstance(want, int) or want.dtype in (torch.bool,
                                                       torch.int32):
                assert (got == want) if isinstance(want, int) \
                    else torch.equal(got, want), (i, name)
            else:
                np.testing.assert_allclose(
                    got.numpy(), want.numpy(), atol=1e-6, rtol=1e-5,
                    err_msg=f"step {i} {name}")
    assert tstate.step == 4 == int(jstate.step)
    assert not torch.equal(tstate.ctrl_state.mask, first_mask)
    if spatial:
        assert (tstate.ctrl_state.cur_block, tstate.ctrl_state.iteration) \
            == (18, 0)
    for (path, got), ref in zip(
            TI.flat_leaves(tstate.params),
            [t for _, t in TI.flat_leaves(
                inr_params_from_jax(_np(jstate.params), {})[0])]):
        np.testing.assert_allclose(got.detach().numpy(), ref.numpy(),
                                   atol=1e-5, err_msg=path)


def test_spatial_train_step_routes_agree():
    """``use_kernel="off"`` (dense mask, autograd) and the fused route take
    the same steps to rounding, and the controller moves alike."""
    vid = moving_texture_video(3, 16, 128, seed=1)
    finals = []
    for use_kernel in ("auto", "off"):
        cfg = _cfgs(spatially_adaptive=True, **KW)[1].replace(
            use_kernel=use_kernel)
        spec, state, consts = TF.create_flow_state(
            torch.Generator().manual_seed(3), cfg)
        step = TF.make_flow_train_step(spec, cfg)
        for i in range(2):
            m = step(state, consts, {
                "frame1": _t(vid[i:i + 1]), "frame2": _t(vid[i + 1:i + 2]),
                "times": torch.tensor([float(i)]), "scale": 8.0})
        finals.append((m["loss"].item(), state.ctrl_state,
                       [t.detach() for _, t in TI.flat_leaves(state.params)]))
    assert abs(finals[0][0] - finals[1][0]) < 1e-6
    assert torch.equal(finals[0][1].in_progress, finals[1][1].in_progress)
    np.testing.assert_allclose(finals[0][1].mask.numpy(),
                               finals[1][1].mask.numpy(), atol=1e-6)
    for a, b in zip(finals[0][2], finals[1][2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def _run_cfg(tmp_path, **kw):
    kw.setdefault("epochs", 4)
    return FlowConfig(device="cpu", net="PFF", num_frequencies=16,
                      hidden_dim=16, num_layers=2, size=24, test_size=24,
                      lr=1e-3, spatial_res=5, splat_max_dy=8, splat_max_dx=8,
                      checkpoints_dir=str(tmp_path / "ck"),
                      results_dir=str(tmp_path / "results"), **kw)


def _states_equal(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, int):
            assert x == y, name
        else:
            assert torch.equal(x, y), name


@pytest.mark.parametrize("spatial", [False, True], ids=["linear", "spatial"])
def test_run_flow_train_checkpoints_and_resumes_the_controller(tmp_path,
                                                               spatial):
    """The checkpoint carries the controller state; a resumed run ends in
    the state of an uninterrupted one, and serving reads it."""
    media = TM.FlowMedia(moving_texture_video(3, 24, 64, seed=1))
    cfg = _run_cfg(tmp_path, spatially_adaptive=spatial, epochs=4)
    whole = TL.run_flow_train(cfg.replace(name="whole"), media=media,
                              scene="clip")
    half = TL.run_flow_train(cfg.replace(epochs=2), media=media, scene="clip")
    saved, at = CheckpointStore(TL.flow_ckpt_dir(cfg, "clip")).restore()
    assert at == 2 and set(saved) == {"params", "consts", "opt", "step",
                                      "ctrl_state"}
    assert saved["ctrl_state"]["kind"] == ("spatial" if spatial else "linear")
    _states_equal(TC.state_from_dict(saved["ctrl_state"]),
                  half["state"].ctrl_state)
    # the mask moved from the initial one in those four steps
    fresh = TF.controller_init(half["state"].ctrl_cfg)
    assert not torch.equal(half["state"].ctrl_state.mask, fresh.mask)
    assert half["state"].ctrl_state.iteration in (4, 0, 1)

    # epochs is part of the controller's schedule (block_iterations), so the
    # resumed run takes the schedule of the 4-epoch config
    again = TL.run_flow_train(cfg, media=media, scene="clip")
    assert again["start_epoch"] == 2 and again["state"].step == 8
    if not spatial:
        # the linear schedule depends on epochs alone: the resumed run ends
        # where the uninterrupted one does
        assert again["state"].ctrl_state.iteration == 8 \
            == whole["state"].ctrl_state.iteration

    # serving restores the controller with the net
    spec, params, consts, _, step, ccfg, cstate = TL._flow_create_and_restore(
        cfg, torch.Generator().manual_seed(9), "clip", require="missing")
    assert step == 4
    _states_equal(cstate, again["state"].ctrl_state)
    out = TL.flow_test_outputs(cfg, media, spec, params, consts, ccfg, cstate)
    assert out["flow12"].shape == (2, 24, 64, 2)
    ref, _ = TF.flow_infer(spec, params, consts,
                           torch.from_numpy(media.times[:1]),
                           float(np.float32(media.flow_scale)), 24, 64, ccfg,
                           cstate)
    np.testing.assert_allclose(out["flow12"][0], ref[0].numpy(), atol=1e-6)
    closed, _ = TF.flow_infer(spec, params, consts,
                              torch.from_numpy(media.times[:1]),
                              float(np.float32(media.flow_scale)), 24, 64,
                              ccfg, cstate._replace(mask=fresh.mask))
    assert (closed - ref).abs().max() > 1e-4      # the mask reaches the net
    frames = TL.interpolate_frames(cfg, media, spec, params, consts, 2, ccfg,
                                   cstate)
    assert frames.shape == (5, 24, 64, 3)
    res = TL.run_flow_test(cfg, media=media, scene="clip")
    assert res["num_frames"] == 2 and os.path.isfile(res["flow_path"])
    assert TL.run_flow_interpolate(cfg, media=media,
                                   scene="clip")["num_frames"] == 5

    # a checkpoint of the other controller, or of another cell grid, or a
    # net without one, is refused by name
    other = cfg.replace(spatially_adaptive=not spatial)
    with pytest.raises(ValueError, match="spatially-adaptive"):
        TL.run_flow_test(other, media=media, scene="clip")
    if spatial:
        with pytest.raises(ValueError, match="spatial-res"):
            TL.run_flow_test(cfg.replace(spatial_res=6), media=media,
                             scene="clip")
    with pytest.raises(ValueError, match="leaves|shape|controller"):
        TL.run_flow_test(cfg.replace(net="FFN"), media=media, scene="clip")


def test_progressive_checkpoint_without_controller_state_is_refused(tmp_path):
    cfg = _run_cfg(tmp_path)
    spec, state, consts = TF.create_flow_state(
        torch.Generator().manual_seed(5), cfg)
    CheckpointStore(TL.flow_ckpt_dir(cfg, "clip")).save(
        1, TL.flow_state_dict(state.params, consts, 3))
    with pytest.raises(ValueError, match="lacks a controller state"):
        TL._flow_create_and_restore(cfg, torch.Generator().manual_seed(5),
                                    "clip")
    d = TL.flow_state_dict(state.params, consts, 3,
                           ctrl_state=state.ctrl_state)
    assert d["ctrl_state"]["kind"] == "linear" and "opt" not in d


def test_flow_config_and_cli_controller_flags(tmp_path, monkeypatch):
    cfg, jcfg = FlowConfig(), JaxFlowConfig()
    for f in ("spatially_adaptive", "spatial_res", "controller_epsilon"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.spatially_adaptive, cfg.spatial_res,
            cfg.controller_epsilon) == (False, 50, 1e-3)
    # the Sintel PFF controllers: the wiring's formulas against JAX's
    for spatial in (False, True):
        j = JaxFlowConfig(net="PFF", spatially_adaptive=spatial)
        t = FlowConfig(net="PFF", spatially_adaptive=spatial, device="cpu")
        jspec = JI.build_inr(jax.random.PRNGKey(0), "PFF", j)[0]
        tspec = TI.build_inr(torch.Generator(), "PFF", t)[0]
        assert tspec.encoding_dim == 515
        jc = (JC.SpatialConfig.create(
            jspec, j.spatial_res, block_iterations=max(
                3 * j.epochs // (4 * max((515 - 6) // 6, 1)), 1),
            epsilon=j.controller_epsilon) if spatial else
            JC.LinearConfig.create(jspec, j.epochs,
                                   epsilon=j.controller_epsilon))
        tc = TF.controller_config(tspec, t)
        assert type(tc).__name__ == type(jc).__name__
        for k, v in jc.__dict__.items():
            assert getattr(tc, k) == v, k
    assert TF.controller_config(
        TI.build_inr(torch.Generator(), "RBF", cfg.replace(device="cpu"))[0],
        cfg) is None

    imageio = pytest.importorskip("imageio.v2")
    frames = tmp_path / "frames" / "scene_a"
    frames.mkdir(parents=True)
    for i, f in enumerate((moving_texture_video(3, 24, 64) * 255
                           ).astype(np.uint8)):
        imageio.imwrite(frames / f"frame_{i + 1:04d}.png", f)
    monkeypatch.chdir(tmp_path)
    args = ["flow", "train", "--input-video", str(frames), "--name", "v",
            "--size", "24", "--test-size", "24", "--num-frequencies", "16",
            "--hidden-dim", "16", "--epochs", "2", "--device", "cpu",
            "--net", "PFF", "--spatially-adaptive", "--spatial-res", "4",
            "--splat-max-dy", "8", "--splat-max-dx", "8"]
    assert cli.main(args) == 0
    ck = tmp_path / "checkpoints" / "scene_a" / "v"
    with open(ck / "scene_a_v.config.json") as f:
        hp = json.load(f)
    assert hp["spatially_adaptive"] and hp["spatial_res"] == 4
    saved, _ = CheckpointStore(str(ck)).restore()
    assert tuple(saved["ctrl_state"]["mask"].shape) == (64, 35)
    assert (tmp_path / "results" / "flow_scene_a_v.json").is_file()
    assert cli.main(["flow", "interpolate"] + args[2:]) == 0

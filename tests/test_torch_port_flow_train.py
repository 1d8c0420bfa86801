"""The port's flow training path held against the JAX package on the CPU:
the photometric losses (also against the torch re-derivation of the
reference formulas in ``parity_torch_ref.py``), LAMB against ``optax.lamb``,
the photometric flow loss on fixed flows, three steps of the train step
against the JAX package's with its Pallas kernels in interpret mode and the
static windows, and ``run_flow_train`` and the ``flow train`` CLI.

All fp32. Tolerances: 1e-5 for the losses and their gradients (fp32
elementwise chains and means summed in another order); 1e-6 for LAMB
(elementwise, the same formulas); 1e-5 relative for the losses of the
three-step trajectory and 1e-5 absolute for its parameters.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import parity_torch_ref as REF
from sin_inn_tpu.core.config import FlowConfig as JaxFlowConfig
from sin_inn_tpu.ops import photometric as JP
from sin_inn_tpu.train import flow as JF
from sin_inn_tpu.train.optim import lamb as jax_lamb
from sin_inn_tpu_torch import cli
from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.data import flow_media as TM
from sin_inn_tpu_torch.data.synthetic import moving_texture_video
from sin_inn_tpu_torch.models.convert import inr_params_from_jax
from sin_inn_tpu_torch.models.inr import flat_leaves
from sin_inn_tpu_torch.ops import photometric as TP
from sin_inn_tpu_torch.ops.cuda import gather as TG
from sin_inn_tpu_torch.ops.cuda import inr as TK7
from sin_inn_tpu_torch.ops.cuda import splat as TK5
from sin_inn_tpu_torch.train import flow as TF
from sin_inn_tpu_torch.train import loop as TL
from sin_inn_tpu_torch.train.optim import lamb
from torch_port_helpers import one_torch_thread  # noqa: F401


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _images(seed, n=2, h=24, w=40):
    rng = np.random.RandomState(seed)
    im1 = rng.rand(n, h, w, 3).astype(np.float32)
    im2 = np.clip(im1 + 0.1 * rng.randn(n, h, w, 3), 0, 1).astype(np.float32)
    mask = (rng.rand(n, h, w, 1) > 0.2).astype(np.float32)
    flow = (3.0 * rng.randn(n, h, w, 2)).astype(np.float32)
    return im1, im2, mask, flow


# ---------------------------------------------------------------------------
# ops/photometric.py: values and gradients against JAX and the reference
# ---------------------------------------------------------------------------

def _check_loss(jax_fn, torch_fn, ref_fn, arrays, diff):
    """One loss, three ways. ``arrays``: the numpy inputs; ``diff``: the
    index of the input the gradient is taken in. ``ref_fn`` takes NCHW."""
    jval, jgrad = jax.value_and_grad(
        lambda a: jax_fn(*[a if i == diff else jnp.asarray(v)
                           for i, v in enumerate(arrays)]))(
        jnp.asarray(arrays[diff]))
    tin = [_t(v) for v in arrays]
    tin[diff].requires_grad_()
    tval = torch_fn(*tin)
    tval.backward()
    rin = [_nchw(v) for v in arrays]
    rin[diff].requires_grad_()
    rval = ref_fn(*rin)
    rval.backward()
    assert abs(tval.item() - float(jval)) < 1e-5
    assert abs(tval.item() - rval.item()) < 1e-5
    np.testing.assert_allclose(tin[diff].grad.numpy(), np.asarray(jgrad),
                               atol=1e-5)
    np.testing.assert_allclose(
        tin[diff].grad.numpy(),
        rin[diff].grad.permute(0, 2, 3, 1).numpy(), atol=1e-5)


def test_masked_l1_matches_jax_and_reference():
    im1, im2, mask, _ = _images(1)
    _check_loss(lambda a, b, m: JP.masked_l1(a, b, m, 0.7),
                lambda a, b, m: TP.masked_l1(a, b, m, 0.7),
                lambda a, b, m: REF.t_masked_l1(a, b, m, 0.7),
                (im1, im2, mask), 0)


@pytest.mark.parametrize("width", [1, 3])
def test_census_loss_matches_jax_and_reference(width):
    im1, im2, mask, _ = _images(2)
    _check_loss(lambda a, b, m: JP.census_loss(a, b, m, 0.3, width),
                lambda a, b, m: TP.census_loss(a, b, m, 0.3, width),
                lambda a, b, m: REF.t_census(a, b, m, 0.3, width),
                (im1, im2, mask), 0)


def test_ternary_transform_and_shift_match_jax():
    im1, _, _, _ = _images(3, n=1)
    got = TP._ternary_transform(_t(im1), 2)
    ref = JP._ternary_transform(jnp.asarray(im1), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    x = im1[..., 0]
    for dy, dx in ((0, 0), (2, -1), (-3, 0), (0, 4), (-1, -2)):
        np.testing.assert_array_equal(
            TP._shift2d(_t(x), dy, dx).numpy(),
            np.asarray(JP._shift2d(jnp.asarray(x), dy, dx)))


def test_ssim_loss_matches_jax_and_reference():
    im1, im2, mask, _ = _images(4)
    _check_loss(lambda a, b, m: JP.ssim_loss(a, b, m, 0.5),
                lambda a, b, m: TP.ssim_loss(a, b, m, 0.5),
                lambda a, b, m: REF.t_ssim(a, b, m, 0.5),
                (im1, im2, mask), 0)


@pytest.mark.parametrize("edge_func,order", [("gauss", 1), ("exp", 1),
                                             ("gauss", 2)])
def test_bilateral_smooth_matches_jax_and_reference(edge_func, order):
    im1, _, _, flow = _images(5)
    _check_loss(
        lambda i, f: JP.bilateral_smooth(i, f, 0.1, edge_func, 10.0, order),
        lambda i, f: TP.bilateral_smooth(i, f, 0.1, edge_func, 10.0, order),
        lambda i, f: REF.t_bilateral_smooth(i, f, 0.1, edge_func, 10.0,
                                            order),
        (im1, flow), 1)


def test_image_grads_robust_l1_and_zero_weights_match_jax():
    im1, im2, mask, flow = _images(6, n=1)
    for stride in (1, 2):
        for g, r in zip(TP.image_grads(_t(im1), stride),
                        JP.image_grads(jnp.asarray(im1), stride)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_allclose(TP.robust_l1(_t(flow)).numpy(),
                               np.asarray(JP.robust_l1(jnp.asarray(flow))),
                               atol=1e-6)
    a, b, m = _t(im1), _t(im2), _t(mask)
    for zero in (TP.masked_l1(a, b, m, 0), TP.census_loss(a, b, m, 0),
                 TP.ssim_loss(a, b, m, 0),
                 TP.bilateral_smooth(a, _t(flow), 0)):
        assert zero.shape == () and zero.item() == 0.0
    with pytest.raises(ValueError):
        TP.bilateral_smooth(a, _t(flow), 0.1, order=3)


# ---------------------------------------------------------------------------
# LAMB
# ---------------------------------------------------------------------------

def test_lamb_matches_optax():
    rng = np.random.RandomState(7)
    tree = {"a": rng.randn(5, 3).astype(np.float32),
            "b": rng.randn(7).astype(np.float32),
            "zero": np.zeros(4, np.float32)}      # trust ratio 1 at |p| = 0
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in tree.items()} for _ in range(5)]
    grads[2]["b"][:] = 0.0

    tx = jax_lamb(1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = tx.init(jp)
    tp = {k: _t(v).requires_grad_() for k, v in tree.items()}
    opt = lamb(list(tp.values()), 1e-2)
    for g in grads:
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                    jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tp.items():
            t.grad = _t(g[k])
        opt.step()
        for k in tree:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-6)
    # the state survives a save and a load
    opt2 = lamb(list(tp.values()), 1e-2)
    opt2.load_state_dict(opt.state_dict())
    assert {s["step"] for s in opt2.state.values()} == {5}


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

KW = dict(net="RBF", num_frequencies=16, hidden_dim=16, num_layers=2,
          splat_max_dy=8, splat_max_dx=8, lr=1e-3)
OCCLS = ["wang", "brox", None]


def _jax_cfg(occl, **kw):
    return JaxFlowConfig(use_pallas="on", splat_local_dy="off",
                         splat_local_dx="off", occl=occl, **dict(KW, **kw))


def _torch_cfg(occl, **kw):
    return FlowConfig(device="cpu", occl=occl, **dict(KW, **kw))


def _fixed_flows(seed, n, h, w, amp):
    rng = np.random.RandomState(seed)
    ys = np.linspace(0, 1, h)[None, :, None]
    xs = np.linspace(0, 1, w)[None, None, :]
    f = lambda a, b: amp * np.sin(2 * np.pi * (a * xs + b * ys)
                                  + rng.uniform(0, 6))
    ones = np.ones((n, 1, 1))
    return [np.stack([f(1, .5) * ones, f(.5, 1) * ones], -1
                     ).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("occl", OCCLS, ids=str)
def test_photometric_flow_loss_matches_jax(occl):
    vid = moving_texture_video(3, 24, 40, seed=2)
    f1, f2 = vid[0:2], vid[1:3]
    fl12, fl21 = _fixed_flows(3, 2, 24, 40, 3.0)
    jloss, jaux = JF.photometric_flow_loss(
        _jax_cfg(occl, loss_ssim=0.2), jnp.asarray(f1), jnp.asarray(f2),
        jnp.asarray(fl12), jnp.asarray(fl21))
    t12, t21 = _t(fl12).requires_grad_(), _t(fl21).requires_grad_()
    tloss, taux = TF.photometric_flow_loss(
        _torch_cfg(occl, loss_ssim=0.2), _t(f1), _t(f2), t12, t21)
    assert abs(tloss.item() - float(jloss)) < 1e-5 * abs(float(jloss))
    for k in ("l1", "census", "ssim", "smooth", "psnr", "flow_max_x",
              "flow_max_y"):
        assert abs(taux[k].item() - float(jaux[k])) < 1e-4, k
    np.testing.assert_allclose(taux["point_loss"].numpy(),
                               np.asarray(jaux["point_loss"]), atol=1e-5)
    assert not any(v.requires_grad for v in taux.values())
    # its flow gradients, through the warps' and the splats' backward
    jg12, jg21 = jax.grad(
        lambda a, b: JF.photometric_flow_loss(
            _jax_cfg(occl, loss_ssim=0.2), jnp.asarray(f1), jnp.asarray(f2),
            a, b)[0], argnums=(0, 1))(jnp.asarray(fl12), jnp.asarray(fl21))
    tloss.backward()
    np.testing.assert_allclose(t12.grad.numpy(), np.asarray(jg12), atol=1e-5)
    np.testing.assert_allclose(t21.grad.numpy(), np.asarray(jg21), atol=1e-5)


@pytest.mark.parametrize("occl", ["wang", None], ids=str)
def test_photometric_flow_loss_matches_reference(occl):
    """Against the torch re-derivation of the reference formulas (exact
    warps and splats): flows well inside the windows."""
    vid = moving_texture_video(3, 24, 40, seed=4)
    f1, f2 = vid[0:2], vid[1:3]
    fl12, fl21 = _fixed_flows(5, 2, 24, 40, 2.0)
    cfg = _torch_cfg(occl, loss_ssim=0.2)
    tloss, taux = TF.photometric_flow_loss(cfg, _t(f1), _t(f2), _t(fl12),
                                           _t(fl21))
    rloss, raux = REF.t_photometric_flow_loss(cfg, _nchw(f1), _nchw(f2),
                                              _nchw(fl12), _nchw(fl21))
    assert abs(tloss.item() - rloss.item()) < 1e-5
    for k, v in raux.items():
        assert abs(taux[k].item() - v.item()) < 1e-5, k


@pytest.mark.parametrize("f0", [2.0, 2.5, -1.0, 0.0])
def test_exact_splat_flow_gradient_matches_jax_at_pixel_centres(f0):
    """Targets on pixel centres (integer flows, zero flow among them): the
    exact scatter's flow gradient is the right derivative in both packages.
    (With ``torch.abs`` in the hat it differed by up to 16 in this case.)"""
    from sin_inn_tpu.ops import splat as JS
    from sin_inn_tpu_torch.ops import splat as TS

    v = np.ones((1, 1, 8, 1), np.float32)
    wgt = (np.arange(8, dtype=np.float32) ** 2).reshape(1, 1, 8, 1)
    fl = np.zeros((1, 1, 8, 2), np.float32)
    fl[0, 0, 2, 0] = f0
    jg = jax.grad(lambda f: jnp.sum(JS.splat_scatter(jnp.asarray(v), f)
                                    * wgt))(jnp.asarray(fl))
    tf = _t(fl).requires_grad_()
    (TS.splat_scatter(_t(v), tf) * _t(wgt)).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jg), atol=1e-6)


def _paired_states(occl):
    jcfg, tcfg = _jax_cfg(occl), _torch_cfg(occl)
    spec, state, consts, ctrl_cfg, tx = JF.create_flow_state(
        jax.random.PRNGKey(0), jcfg)
    assert spec.use_pallas == "on" and ctrl_cfg is None
    jstep = JF.make_flow_train_step(spec, jcfg, ctrl_cfg, tx)
    tp, tc = inr_params_from_jax(_np(state.params), _np(consts))
    tspec = TF.build_flow_model(torch.Generator().manual_seed(0), tcfg)[0]
    tstate = TF.train_state(tp, tcfg)
    tstep = TF.make_flow_train_step(tspec, tcfg)
    return (jstep, state, consts), (tstep, tstate, tc)


@pytest.mark.parametrize("occl", OCCLS, ids=str)
def test_three_train_steps_match_jax(occl):
    """The slice end to end: INR forward, K7's backward (the plain version
    here, the Pallas kernel in interpret mode there), the windowed warps and
    splats with their gradient-mode backward, the losses, LAMB."""
    (jstep, jstate, jconsts), (tstep, tstate, tconsts) = _paired_states(occl)
    vid = moving_texture_video(4, 24, 40, seed=1)
    times = np.linspace(-1, 1, 4).astype(np.float32)
    gt = _fixed_flows(9, 1, 24, 40, 1.0)[0]
    for i in range(3):
        b = {"frame1": vid[i:i + 1], "frame2": vid[i + 1:i + 2],
             "times": times[i:i + 1], "scale": np.float32(8.0),
             "gt_flow": gt}
        jstate, jm = jstep(jstate, jconsts,
                           {k: jnp.asarray(v) for k, v in b.items()})
        tm = tstep(tstate, tconsts, {k: (float(v) if k == "scale"
                                         else torch.as_tensor(v))
                                     for k, v in b.items()})
        assert set(tm) == set(jm)
        assert abs(tm["loss"].item() - float(jm["loss"])) \
            < 1e-5 * abs(float(jm["loss"]))
        assert abs(tm["epe"].item() - float(jm["epe"])) < 1e-5
        assert not any(v.requires_grad for v in tm.values())
    assert tstate.step == 3 == int(jstate.step)
    for (path, got), ref in zip(
            flat_leaves(tstate.params),
            [t for _, t in flat_leaves(
                inr_params_from_jax(_np(jstate.params), {})[0])]):
        np.testing.assert_allclose(got.detach().numpy(), ref.numpy(),
                                   atol=1e-5, err_msg=path)


def test_train_step_off_route_takes_the_same_steps():
    """``use_kernel="off"`` (autograd through the plain INR) and the fused
    route agree to rounding on the CPU."""
    vid = moving_texture_video(3, 24, 40, seed=1)
    finals = []
    for use_kernel in ("auto", "off"):
        cfg = _torch_cfg("wang", use_kernel=use_kernel)
        spec, state, consts = TF.create_flow_state(
            torch.Generator().manual_seed(3), cfg)
        assert spec.use_kernel == use_kernel
        step = TF.make_flow_train_step(spec, cfg)
        for i in range(2):
            m = step(state, consts, {
                "frame1": _t(vid[i:i + 1]), "frame2": _t(vid[i + 1:i + 2]),
                "times": torch.tensor([float(i)]), "scale": 8.0})
        finals.append((m["loss"].item(),
                       [t.detach() for _, t in flat_leaves(state.params)]))
    assert abs(finals[0][0] - finals[1][0]) < 1e-6
    for a, b in zip(finals[0][1], finals[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# run_flow_train and the CLI
# ---------------------------------------------------------------------------

def _run_cfg(tmp_path, **kw):
    kw.setdefault("epochs", 2)
    return FlowConfig(device="cpu", num_frequencies=16, hidden_dim=16,
                      num_layers=2, size=24, test_size=24, lr=1e-3,
                      checkpoints_dir=str(tmp_path / "ck"),
                      results_dir=str(tmp_path / "results"), **kw)


def _media(with_gt=False):
    vid = moving_texture_video(4, 24, 40, seed=1)
    flow = (np.stack(_fixed_flows(2, 1, 24, 40, 1.0) * 2)[:3, 0]
            if with_gt else None)
    return TM.FlowMedia(vid, flow)


def test_run_flow_train_writes_checkpoints_metrics_and_sidecar(tmp_path):
    cfg = _run_cfg(tmp_path, splat_max_dy=8, splat_max_dx=8, val_iter=1)
    media = _media(with_gt=True)
    for mod in (TG, TK5, TK7):
        mod.reset_launch_counts()
    out = TL.run_flow_train(cfg, media=media, val_media=media, scene="clip")
    assert out["start_epoch"] == 0 and out["state"].step == 6
    assert (out["cfg"].splat_max_dy, out["cfg"].splat_max_dx) == (8, 8)
    m = out["metrics"]
    assert {"loss", "l1", "census", "smooth", "psnr", "epe", "val_epe",
            "frames_per_sec", "flow_max_x", "flow_max_y"} <= set(m)
    assert all(np.isfinite(v) for v in m.values())
    ck = TL.flow_ckpt_dir(cfg, "clip")
    with open(os.path.join(ck, "clip_temp.metrics.jsonl")) as f:
        recs = [json.loads(l) for l in f]
    assert [r["step"] for r in recs] == [0, 1]
    with open(os.path.join(ck, "window_bounds.json")) as f:
        side = json.load(f)
    # the refit monitor's maxima ride along (the local bounds never engaged)
    assert set(side.pop("hist")) == {"fy", "fx"}
    assert side == {"fh": 24, "fw": 40, "splat_max_dy": 8,
                    "splat_max_dx": 8, "splat_local_dy": None,
                    "splat_local_dx": None}
    saved, at = CheckpointStore(ck).restore()
    assert at == 2 and set(saved) == {"params", "consts", "opt", "step"}
    assert saved["step"] == 6
    # CPU tensors: the plain versions, no kernel launch counted
    assert all(v == 0 for mod in (TG, TK5, TK7)
               for v in mod.launch_counts().values())

    # a rerun resumes at the saved epoch with the optimizer state, and picks
    # the trained bounds up from the sidecar
    again = TL.run_flow_train(cfg.replace(epochs=3, splat_max_dy="auto",
                                          splat_max_dx="auto"),
                              media=media, scene="clip")
    assert again["start_epoch"] == 2 and again["state"].step == 9
    assert {s["step"] for s in
            again["state"].optimizer.state.values()} == {9}
    assert (again["cfg"].splat_max_dy, again["cfg"].splat_max_dx) == (8, 8)
    assert len(again["metrics"]) and "val_epe" not in again["metrics"]

    # flow test and interpolation serve the training checkpoint
    res = TL.run_flow_test(cfg, media=media, scene="clip")
    assert res["num_frames"] == 3 and np.isfinite(res["epe"])
    assert os.path.isfile(res["flow_path"])
    interp = TL.run_flow_interpolate(cfg, media=media, scene="clip")
    assert interp["num_frames"] == 7


def test_run_flow_train_resumes_from_a_serving_checkpoint(tmp_path):
    """A ``{"params", "consts", "step"}`` checkpoint (no optimizer state)
    still restores: serving reads it, training starts a fresh optimizer."""
    cfg = _run_cfg(tmp_path, epochs=2)
    spec, state, consts = TF.create_flow_state(
        torch.Generator().manual_seed(5), cfg)
    CheckpointStore(TL.flow_ckpt_dir(cfg, "clip")).save(
        1, TL.flow_state_dict(state.params, consts, 3))
    out = TL.run_flow_train(cfg, media=_media(), scene="clip")
    assert out["start_epoch"] == 1 and out["state"].step == 6
    assert {s["step"] for s in out["state"].optimizer.state.values()} == {3}
    assert out["cfg"].splat_max_dy is None      # 24x40: the exact routes
    served = TL.flow_test_outputs(cfg, _media(), out["spec"],
                                  out["state"].params, out["consts"])
    assert served["flow12"].shape == (3, 24, 40, 2)


def test_run_flow_train_warns_when_flow_outgrows_the_window(tmp_path, caplog):
    cfg = _run_cfg(tmp_path, epochs=1, splat_max_dy=1, splat_max_dx=1)
    with caplog.at_level("WARNING"):
        TL.run_flow_train(cfg, media=_media(), scene="clip")
    assert "exceeds the splat window bounds" in caplog.text


def test_flow_train_defaults_to_cuda_and_raises_without_a_card(monkeypatch,
                                                               tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _run_cfg(tmp_path).replace(device="cuda")
    assert FlowConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.run_flow_train(cfg, media=_media(), scene="clip")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["flow", "train", "--epochs", "1"])


def test_flow_config_training_fields():
    cfg = FlowConfig()
    assert (cfg.batch, cfg.epochs, cfg.lr, cfg.loss_l1, cfg.loss_census,
            cfg.loss_ssim, cfg.census_width, cfg.loss_smooth1,
            cfg.edge_constant, cfg.edge_func) == (
        1, 1000, 1e-4, 1.0, 0.1, 0.0, 3, 0.1, 150.0, "gauss")
    jcfg = JaxFlowConfig()
    for f in ("batch", "epochs", "val_iter", "lr", "loss_l1", "loss_census",
              "loss_ssim", "census_width", "loss_smooth1", "edge_constant",
              "edge_func", "occl", "random_seed"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.effective_val_iter == 1001 == jcfg.effective_val_iter
    assert cfg.replace(val_iter=7).effective_val_iter == 7
    with pytest.raises(ValueError, match="edge_func"):
        FlowConfig(edge_func="box")
    # the multi-GPU fields came with the parallel slice, and the polynomial
    # encoding's degree with the encoding
    for f in ("mesh_data", "distributed", "dist_coordinator",
              "dist_num_processes", "dist_process_id", "data_axis",
              "power"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.model_params() == jcfg.model_params()
    # the import and profiling fields came with the flow exchange and
    # tooling, the pseudo-GT producer with RAFT
    for f in ("import_torch", "profile_steps", "flow_producer"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    # the local-window and refit fields came with the local windows
    for f in ("splat_local_dy", "splat_local_dx", "window_refit",
              "splat_chunk", "splat_col_chunk", "resample_chunk"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    # the controllers' fields came with the progressive nets
    for f in ("spatially_adaptive", "spatial_res", "controller_epsilon"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_flow_train_cli(tmp_path, monkeypatch):
    imageio = pytest.importorskip("imageio.v2")
    frames = tmp_path / "frames" / "scene_a"
    frames.mkdir(parents=True)
    for i, f in enumerate((moving_texture_video(4, 24, 40) * 255
                           ).astype(np.uint8)):
        imageio.imwrite(frames / f"frame_{i + 1:04d}.png", f)
    monkeypatch.chdir(tmp_path)
    args = ["flow", "train", "--input-video", str(frames), "--name", "v",
            "--size", "24", "--test-size", "24", "--num-frequencies", "16",
            "--hidden-dim", "16", "--epochs", "2", "--device", "cpu",
            "--lr", "1e-3", "--loss-ssim", "0.1", "--occl", "brox",
            "--edge-func", "exp", "--use-kernel", "off"]
    assert cli.main(args) == 0
    ck = tmp_path / "checkpoints" / "scene_a" / "v"
    assert (ck / "step_0000000002" / "state.pt").is_file()
    assert (ck / "window_bounds.json").is_file()
    with open(ck / "scene_a_v.config.json") as f:
        hp = json.load(f)
    assert hp["use_kernel"] == "off" and hp["edge_func"] == "exp"
    # the test pass after training
    assert (tmp_path / "results" / "flow_scene_a_v.json").is_file()
    assert (tmp_path / "results" / "occl_scene_a_v.gif").is_file()

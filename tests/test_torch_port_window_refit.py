"""The window bounds of the flow path held against the JAX package on the
CPU: ``resolve_splat_bounds`` with the local fields, ``_q16`` / ``_q8p``,
the GT-flow probe, the mid-training refit, the sidecar and
``_inference_bounds`` (the same config in, the same bounds out, over the
input tables of the JAX package's own tests); the photometric loss on the
local-window route and on ``use_kernel="off"`` (the windowed forms) against
JAX's ``use_pallas="on"`` (interpret mode) and ``"off"``; and
``run_flow_train`` with GT flow (probe, a refit that fires, the sidecar with
the local bounds and the monitor's history, a resume), ``flow interpolate``
from a local-window sidecar and the CLI flags.

Tolerances: bounds exactly equal; losses 1e-5 relative, monitors 1e-4 px,
flow gradients 1e-5 (the static route's tolerance in
``test_torch_port_flow_train.py``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import FlowConfig as JaxFlowConfig
from sin_inn_tpu.train import flow as JF
from sin_inn_tpu.train import loop as JL
from sin_inn_tpu_torch import cli
from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.data import flow_media as TM
from sin_inn_tpu_torch.data.synthetic import moving_texture_video
from sin_inn_tpu_torch.ops.cuda import gather as TG
from sin_inn_tpu_torch.ops.cuda import splat as TK5
from sin_inn_tpu_torch.train import flow as TF
from sin_inn_tpu_torch.train import loop as TL
from torch_port_helpers import one_torch_thread  # noqa: F401

KEYS = FlowConfig.WINDOW_BOUND_KEYS


def _bounds(cfg):
    return None if cfg is None else tuple(getattr(cfg, k) for k in KEYS)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _smooth(n, h, w, detail, drift_x=-15.0, drift_y=20.0, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for _ in range(n):
        ph = rng.uniform(0, 6, 2)
        base = np.stack([drift_x + 0.0371 + 6.0 * xx / w,
                         drift_y + 0.0371 + 3.0 * yy / h], -1)
        wave = np.stack([np.cos(xx / 17.0 + yy / 21.0 + ph[0]),
                         np.sin(xx / 19.0 - yy / 15.0 + ph[1])], -1)
        out.append(base + detail * 0.97123 * wave)
    return np.stack(out).astype(np.float32)


# ---------------------------------------------------------------------------
# Config rules
# ---------------------------------------------------------------------------

LOCAL_PINS = [dict(splat_local_dy=16), dict(splat_local_dy="off"),
              dict(splat_local_dy=80), dict(splat_local_dy=None),
              dict(splat_local_dx=64), dict(splat_local_dx="off"),
              dict(splat_local_dy=16, splat_local_dx=96, splat_max_dx=512),
              dict(splat_local_dy=8, splat_local_dx=128, splat_max_dx=160),
              dict(splat_max_dy=16, splat_max_dx=16),
              dict(splat_max_dy=24, splat_max_dx="off")]


@pytest.mark.parametrize("hw", [(436, 1024), (24, 40), (200, 260),
                                (1080, 1920)])
def test_resolve_splat_bounds_local_fields_match_jax(hw):
    for kw in LOCAL_PINS:
        got = FlowConfig(**kw).resolve_splat_bounds(*hw)
        ref = JaxFlowConfig(**kw).resolve_splat_bounds(*hw)
        assert _bounds(got) == _bounds(ref), (kw, hw)
        assert got.resolve_splat_bounds(*hw) == got
    # the defaults at Sintel size: local dy 32 under dy 64, dx 128
    assert _bounds(FlowConfig().resolve_splat_bounds(436, 1024)) == (
        64, 128, 32, None)


def test_flow_config_window_fields_match_jax():
    cfg, jcfg = FlowConfig(), JaxFlowConfig()
    for f in ("splat_chunk", "splat_col_chunk", "resample_chunk",
              "splat_local_dy", "splat_local_dx", "window_refit"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for bad in (dict(window_refit="always"), dict(splat_local_dy="some")):
        with pytest.raises(ValueError):
            FlowConfig(**bad)


def test_q16_q8p_match_jax():
    for v in (0.0, 0.4, 5.0, 10.67, 10.7, 20.0, 42.7, 63.5, 100.0, 250.0):
        assert TL._q16(v) == JL._q16(v)
        assert TL._q8p(v) == JL._q8p(v)


class _Media:
    """GT flow of the given shape, with constant or smooth fields."""

    def __init__(self, flow):
        self.flow = flow

    @property
    def gt_available(self):
        return self.flow is not None


def _const(shape, fx=0.0, fy=0.0):
    f = np.zeros(shape + (2,), np.float32)
    f[..., 0], f[..., 1] = fx, fy
    return f


PROBES = [
    # the GT probe tables of tests/test_flow_train.py
    (dict(), _const((2, 436, 1024), 20.0, 20.0)),
    (dict(splat_max_dx=96), _const((2, 436, 1024), 20.0, 20.0)),
    (dict(splat_max_dy=80), _const((2, 436, 1024), 20.0, 20.0)),
    (dict(splat_max_dy=80, splat_max_dx=96), _const((2, 436, 1024), 20.0,
                                                    20.0)),
    (dict(), _const((2, 436, 1024), 0.0, 300.0)),
    (dict(splat_max_dx=128), _const((2, 436, 1024), 0.0, 300.0)),
    (dict(splat_max_dy=64), _const((2, 436, 1024), 400.0, 0.0)),
    (dict(splat_local_dx=96), _const((2, 436, 1024), 300.0, 0.0)),
    (dict(splat_local_dx=96), _const((2, 436, 1024), 80.0, 0.0)),
    # smooth fields: the local row bound from the deviation, and the local
    # column bound engaged on a fast pan
    (dict(), _smooth(2, 436, 1024, 3.0)),
    (dict(), _smooth(1, 436, 1024, 4.0, drift_x=180.0)),
    (dict(splat_local_dy="off"), _smooth(1, 436, 1024, 4.0)),
    (dict(splat_local_dy=16), _smooth(1, 436, 1024, 9.0)),
    (dict(), None),
]


@pytest.mark.parametrize("case", range(len(PROBES)))
def test_gt_probe_matches_jax(case):
    kw, flow = PROBES[case]
    got = TL._resolve_and_probe_splat_bounds(FlowConfig(**kw), _Media(flow),
                                             436, 1024)
    ref = JL._resolve_and_probe_splat_bounds(JaxFlowConfig(**kw),
                                             _Media(flow), 436, 1024)
    assert _bounds(got) == _bounds(ref), kw


ALL = {"dy": True, "dx": True, "ldy": True, "ldx": True}
C64 = dict(splat_max_dy=64, splat_max_dx=128, splat_local_dy=32,
           splat_local_dx=None)
REFITS = [
    # (bounds, since, hist or None (= since), auto, fw, allow_tighten): the
    # refit tables of tests/test_flow_train.py
    (dict(C64, splat_local_dy=16), {"fy": 63.5, "fx": 30.0, "dvy": 5.0,
                                    "dvx": 30.0}, None, ALL, 2048, False),
    (dict(C64, splat_local_dy=16), {"fy": 30.0, "fx": 30.0, "dvy": 14.0,
                                    "dvx": 0.0}, None, ALL, 2048, False),
    (dict(C64, splat_local_dy=16), {"fy": 63.5, "fx": 30.0, "dvy": 5.0,
                                    "dvx": 30.0}, None,
     dict(ALL, dy=False), 2048, False),
    (C64, {"fy": 5.0, "fx": 5.0, "dvy": 4.0, "dvx": 4.0},
     {"fy": 20.0, "fx": 90.0, "dvy": 8.0, "dvx": 8.0}, ALL, 2048, True),
    (C64, {"fy": 5.0, "fx": 5.0, "dvy": 4.0, "dvx": 4.0},
     {"fy": 20.0, "fx": 90.0, "dvy": 8.0, "dvx": 8.0}, ALL, 2048, False),
    (C64, {"fy": 5.0, "fx": 5.0, "dvy": 4.0, "dvx": 4.0},
     {"fy": 40.0, "fx": 90.0, "dvy": 20.0, "dvx": 8.0}, ALL, 2048, True),
    (C64, {"fy": 250.0, "fx": 10.0, "dvy": 5.0, "dvx": 5.0}, None, ALL, 2048,
     False),
    (C64, {"fy": 40.0, "fx": 10.0, "dvy": 50.0, "dvx": 5.0}, None, ALL,
     2048, False),
    (dict(splat_max_dy=None, splat_max_dx=None, splat_local_dy=None,
          splat_local_dx=None), {"fy": 9.0, "fx": 9.0}, None, ALL, 2048,
     True),
    (dict(splat_max_dy=32, splat_max_dx=512, splat_local_dy=8,
          splat_local_dx=128), {"fy": 10.0, "fx": 400.0, "dvy": 2.0,
                                "dvx": 126.0}, None, ALL, 2048, False),
    (dict(splat_max_dy=32, splat_max_dx=512, splat_local_dy=8,
          splat_local_dx=256), {"fy": 10.0, "fx": 400.0, "dvy": 2.0,
                                "dvx": 10.0}, None, ALL, 2048, True),
    (dict(splat_max_dy=32, splat_max_dx=512, splat_local_dy=8,
          splat_local_dx=None), {"fy": 10.0, "fx": 400.0, "dvy": 4.0,
                                 "dvx": 10.0}, None, ALL, 2048, False),
    (C64, {"fy": 250.0, "fx": 10.0, "dvy": 5.0, "dvx": 5.0}, None,
     dict(ALL, dx=False), 2048, False),
    (dict(C64, splat_local_dy=None), {"fy": 10.0, "fx": 10.0, "dvy": None,
                                      "dvx": None},
     {"fy": 40.0, "fx": 40.0, "dvy": 8.0, "dvx": 8.0}, ALL, 2048, False),
    (dict(C64, splat_local_dy=None), {"fy": 10.0, "fx": 10.0, "dvy": None,
                                      "dvx": None},
     {"fy": 40.0, "fx": 40.0}, ALL, 2048, False),
    # the smoke's case: 4-5 px flows at Sintel size, tightening allowed
    (C64, {"fy": 4.6, "fx": 5.1, "dvy": 5.3, "dvx": 5.1}, None, ALL, 1024,
     True),
    (C64, {"fy": 4.6, "fx": 5.1, "dvy": 1.2, "dvx": 5.1}, None, ALL, 1024,
     True),
]


@pytest.mark.parametrize("case", range(len(REFITS)))
def test_window_refit_matches_jax(case):
    bounds, since, hist, auto, fw, tighten = REFITS[case]
    hist = hist or since
    got = TL._refit_window_bounds(FlowConfig(**bounds), auto, 436, fw, since,
                                  hist, tighten)
    ref = JL._refit_window_bounds(JaxFlowConfig(**bounds), auto, 436, fw,
                                  since, hist, tighten)
    assert _bounds(got) == _bounds(ref)


def test_sidecar_history_and_inference_bounds_match_jax(tmp_path):
    d = str(tmp_path)
    trained = FlowConfig(splat_max_dy=96, splat_max_dx=160,
                         splat_local_dy=16, splat_local_dx=None)
    hist = {"fy": 20.0, "fx": 30.0, "dvy": 8.0}
    TL._save_window_bounds(d, trained, 436, 1024, hist)
    assert TL._load_window_hist(d, 436, 1024) == JL._load_window_hist(
        d, 436, 1024) == hist
    assert TL._load_window_hist(d, 128, 128) == {}
    for kw, size in ((dict(), (436, 1024)), (dict(splat_max_dy=48),
                                             (436, 1024)),
                     (dict(splat_local_dy="off"), (436, 1024)),
                     (dict(), (218, 512))):
        got, found = TL._load_window_bounds(FlowConfig(**kw), d, *size)
        ref, jfound = JL._load_window_bounds(JaxFlowConfig(**kw), d, *size)
        assert found == jfound
        assert _bounds(TL._inference_bounds(got)) == _bounds(
            JL._inference_bounds(ref)), kw
    assert _bounds(TL._inference_bounds(FlowConfig())) == (
        "auto", "auto", "off", "off")
    # a pinned local bound passes through
    assert TL._inference_bounds(FlowConfig(splat_local_dy=16)
                                ).splat_local_dy == 16


# ---------------------------------------------------------------------------
# The loss on the local route and on use_kernel="off"
# ---------------------------------------------------------------------------

KW = dict(net="RBF", num_frequencies=16, hidden_dim=16, num_layers=2,
          splat_max_dy=32, splat_max_dx=32, lr=1e-3)


@pytest.mark.parametrize("route", ["local", "off"])
def test_photometric_flow_loss_local_and_off_routes_match_jax(route):
    h, w = 64, 96
    vid = moving_texture_video(3, h, w, seed=2)
    f1, f2 = vid[0:1], vid[1:2]
    fl12 = _smooth(1, h, w, 3.0, drift_x=-4.0, drift_y=11.0, seed=1)
    fl21 = -_smooth(1, h, w, 3.0, drift_x=-4.0, drift_y=11.0, seed=2)
    jcfg = JaxFlowConfig(use_pallas="on" if route == "local" else "off",
                         **KW)
    tcfg = FlowConfig(device="cpu", use_kernel="auto" if route == "local"
                      else "off", **KW)
    _, _, local = TF._splat_ops(tcfg.resolve_splat_bounds(h, w))
    assert (local is not None) == (route == "local")

    def jloss(a, b):
        return JF.photometric_flow_loss(jcfg, jnp.asarray(f1),
                                        jnp.asarray(f2), a, b)

    (jl, jaux), (jg12, jg21) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(fl12),
                                             jnp.asarray(fl21))
    t12, t21 = _t(fl12).requires_grad_(), _t(fl21).requires_grad_()
    tl, taux = TF.photometric_flow_loss(tcfg, _t(f1), _t(f2), t12, t21)
    tl.backward()
    if route == "local":
        # the row offsets are on: the windows moved with the drift
        offs = TF._flow_offsets(t12, local)
        assert offs.off_src[..., 1].abs().min() >= 8
    assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl))
    keys = {"flow_max_x", "flow_max_y"} | (
        {"flow_dev_x", "flow_dev_y"} if route == "local" else set())
    assert keys <= set(taux) and set(jaux) >= keys
    assert ("flow_dev_y" in taux) == (route == "local")
    for k in keys:
        assert abs(taux[k].item() - float(jaux[k])) <= 1e-4, k
    np.testing.assert_allclose(t12.grad.numpy(), np.asarray(jg12), atol=1e-5)
    np.testing.assert_allclose(t21.grad.numpy(), np.asarray(jg21), atol=1e-5)


def test_splat_ops_route_table():
    """The five routes of ``_splat_ops``, by the bounds and use_kernel."""
    cpu = dict(device="cpu")
    sizes = (436, 1024)
    img, fl = torch.rand(1, 24, 40, 3), 2.0 * torch.rand(1, 24, 40, 2)
    routes = {
        "local": FlowConfig(**cpu),
        "static": FlowConfig(splat_local_dy="off", **cpu),
        "off": FlowConfig(use_kernel="off", **cpu),
        "rows": FlowConfig(splat_max_dy=16, splat_max_dx="off", **cpu),
        "exact": FlowConfig(splat_max_dy="off", **cpu),
    }
    for name, cfg in routes.items():
        warp, splat, local = TF._splat_ops(cfg.resolve_splat_bounds(*sizes))
        assert (local is not None) == (name == "local"), name
        offs = TF._flow_offsets(fl, local)
        metric = -torch.rand(1, 24, 40, 1)
        soft, cov = splat(img, fl, metric, offs)
        assert soft.shape == img.shape and cov.shape == metric.shape
        assert warp(img, fl, offs).shape == img.shape
    assert TF._splat_ops(routes["local"].resolve_splat_bounds(*sizes))[2] == (
        32, 128, 64, 0)


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------

H, W = 136, 160


def _run_cfg(tmp_path, **kw):
    return FlowConfig(device="cpu", num_frequencies=16, hidden_dim=16,
                      num_layers=2, size=H, test_size=H, lr=1e-3,
                      checkpoints_dir=str(tmp_path / "ck"),
                      results_dir=str(tmp_path / "results"), **kw)


def _gt_media():
    vid = moving_texture_video(3, H, W, seed=4)
    return TM.FlowMedia(vid, _smooth(2, H, W, 2.0, drift_x=3.0, drift_y=9.0))


def test_run_flow_train_probes_refits_and_resumes(tmp_path, monkeypatch):
    built = []
    real = TF.make_flow_train_step
    monkeypatch.setattr(
        TF, "make_flow_train_step", lambda spec, cfg, mesh=None:
        built.append(cfg) or real(spec, cfg, mesh=mesh))
    media = _gt_media()
    cfg = _run_cfg(tmp_path, epochs=2)
    out = TL.run_flow_train(cfg, media=media, scene="clip")
    probed = JL._resolve_and_probe_splat_bounds(
        JaxFlowConfig(), _Media(media.flow), H, W)
    assert _bounds(built[0]) == _bounds(probed)
    assert built[0].splat_local_dy, "the probe left local mode off"
    # the second save tightens from the monitor's history: one refit
    ck = TL.flow_ckpt_dir(cfg, "clip")
    with open(os.path.join(ck, "window_bounds.json")) as f:
        side = json.load(f)
    hist = side.pop("hist")
    assert set(hist) == {"fy", "fx", "dvy", "dvx"}
    assert len(built) == 2 and out["cfg"] == built[1]
    refit = JL._refit_window_bounds(
        JaxFlowConfig(**dict(zip(KEYS, _bounds(built[0])))), dict(
            dy=True, dx=True, ldy=True, ldx=True), H, W, hist, hist, True)
    assert _bounds(out["cfg"]) == _bounds(refit)
    assert side == {"fh": H, "fw": W, **dict(zip(KEYS, _bounds(out["cfg"])))}
    # a resume restores the refitted bounds and the history
    built.clear()
    again = TL.run_flow_train(cfg.replace(epochs=3), media=media,
                              scene="clip")
    assert again["start_epoch"] == 2 and again["state"].step == 6
    assert _bounds(built[0]) == _bounds(out["cfg"])
    new_hist = TL._load_window_hist(ck, H, W)
    assert all(new_hist[k] >= v for k, v in hist.items())
    # with the refit off the probed bounds stay
    built.clear()
    static = TL.run_flow_train(cfg.replace(window_refit="off", name="static"),
                               media=media, scene="clip")
    assert len(built) == 1 and static["cfg"] == built[0]


def test_flow_interpolate_serves_a_local_window_sidecar(tmp_path,
                                                        monkeypatch):
    cfg = _run_cfg(tmp_path, epochs=1, splat_local_dy="off")
    media = TM.FlowMedia(moving_texture_video(3, H, W, seed=4))
    TL.run_flow_train(cfg, media=media, scene="clip")
    ck = TL.flow_ckpt_dir(cfg, "clip")
    TL._save_window_bounds(ck, FlowConfig(splat_max_dy=16, splat_max_dx=16,
                                          splat_local_dy=8,
                                          splat_local_dx=None), H, W)
    calls = []
    real = TF.softsplat_region_local_with_coverage
    monkeypatch.setattr(
        TF, "softsplat_region_local_with_coverage",
        lambda *a: calls.append(a[3:5]) or real(*a))
    TG.reset_launch_counts()
    TK5.reset_launch_counts()
    out = TL.run_flow_interpolate(FlowConfig(**{
        f: getattr(cfg, f) for f in ("device", "num_frequencies",
                                     "hidden_dim", "num_layers", "size",
                                     "test_size", "checkpoints_dir",
                                     "results_dir")}), media=media,
        scene="clip")
    assert out["num_frames"] == 5 and os.path.isfile(out["path"])
    # two mid-frames, two local splats each, at local dy 8 and dx 16
    assert calls == [(8, 16)] * 4
    assert set(TG.launch_counts().values()) == {0}
    assert set(TK5.launch_counts().values()) == {0}


def test_frame_interp_local_route_matches_jax():
    jcfg = JaxFlowConfig(num_frequencies=16, hidden_dim=16, num_layers=2,
                         splat_max_dy=16, splat_max_dx=16, splat_local_dy=8,
                         use_pallas="on")
    tcfg = FlowConfig(num_frequencies=16, hidden_dim=16, num_layers=2,
                      splat_max_dy=16, splat_max_dx=16, splat_local_dy=8,
                      device="cpu").resolve_splat_bounds(H, W)
    from sin_inn_tpu.models import inr as JI
    from sin_inn_tpu_torch.models import inr as TI
    from sin_inn_tpu_torch.models.convert import inr_params_from_jax
    spec, params, consts = JI.build_inr(jax.random.key(3), "RBF", jcfg)
    tspec, _, _ = TI.build_inr(torch.Generator(), "RBF", tcfg)
    tp, tc = inr_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 jax.tree_util.tree_map(np.asarray, consts))
    pair = moving_texture_video(2, H, W, seed=5)
    ref = JF.make_frame_interp(spec, jcfg, None)(
        params, consts, None, jnp.float32(0.2), jnp.asarray(pair),
        jnp.float32(0.5), jnp.float32(60.0))
    got = TF.frame_interp(tspec, tcfg, tp, tc, 0.2, _t(pair), 0.5, 60.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_flow_cli_window_flags():
    import argparse
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command", required=True)
    cli._flow_parser(sub)
    a = parser.parse_args(["flow", "train", "--splat-local-dy", "16",
                           "--splat-local-dx", "off", "--window-refit", "off",
                           "--splat-chunk", "4", "--splat-col-chunk", "128"])
    cfg = cli.flow_config_from_args(a)
    assert (cfg.splat_local_dy, cfg.splat_local_dx, cfg.window_refit,
            cfg.splat_chunk, cfg.splat_col_chunk) == (16, "off", "off", 4,
                                                      128)
    cfg = cli.flow_config_from_args(parser.parse_args(["flow", "train"]))
    assert (cfg.splat_local_dy, cfg.splat_local_dx, cfg.window_refit) == (
        "auto", "auto", "auto")

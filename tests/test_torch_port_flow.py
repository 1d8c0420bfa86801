"""The port's flow serving slice held against the JAX package on the CPU:
``flow_infer`` and ``frame_interp`` against ``make_flow_infer`` and
``make_frame_interp`` (the JAX side on its Pallas kernels in interpret
mode, window bounds pinned to 8/8 so the kernel route runs at 24x40), the
checkpoint restore, ``run_flow_test`` / ``run_flow_interpolate`` and the
``flow test`` / ``flow interpolate`` CLI end to end on ``--device cpu``.

Tolerances: flows within 1e-4 px (fp32 INR products summed in another
order, times the flow scale); mid-frames within 1e-4; alpha = 0 and
1 reproduce the endpoint frames within 1e-5 (one softmax normalisation).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import FlowConfig as JaxFlowConfig
from sin_inn_tpu.models import inr as JI
from sin_inn_tpu.ops import occlusion as JO
from sin_inn_tpu.train import flow as JFT
from sin_inn_tpu_torch import cli
from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.data import flo as TFLO
from sin_inn_tpu_torch.data import flow_media as TM
from sin_inn_tpu_torch.data.synthetic import moving_texture_video
from sin_inn_tpu_torch.models import inr as TI
from sin_inn_tpu_torch.models.convert import inr_params_from_jax
from sin_inn_tpu_torch.ops.cuda import gather as TG
from sin_inn_tpu_torch.ops.cuda import splat as TK5
from sin_inn_tpu_torch.train import flow as TF
from sin_inn_tpu_torch.train import loop as TL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 24, 40
NET = dict(num_frequencies=64, hidden_dim=128)
# flow scale of the parity tests: the seeded net's outputs (about 0.07)
# become flows of about 2 px per frame
SCALE = 32.0
TINY = dict(num_frequencies=16, hidden_dim=16)


@pytest.fixture(scope="module")
def video():
    return moving_texture_video(4, H, W, seed=3)


@pytest.fixture(scope="module", params=["kernels", "exact"])
def models(request):
    """JAX and port configs and the same RBF net in both layouts. 'kernels':
    bounds pinned to 8/8, so K5/K6 (JAX: interpret mode) run; 'exact':
    frames under 128 px take the exact scatter and resample2d."""
    bounds = (dict(splat_max_dy=8, splat_max_dx=8)
              if request.param == "kernels" else {})
    jcfg = JaxFlowConfig(**NET, **bounds, use_pallas="on")
    tcfg = FlowConfig(**NET, **bounds, device="cpu")
    spec, params, consts = JI.build_inr(jax.random.key(7), "RBF", jcfg)
    tspec, _, _ = TI.build_inr(torch.Generator(), "RBF", tcfg)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tp, tc = inr_params_from_jax(np_tree(params), np_tree(consts))
    return jcfg, tcfg, spec, params, consts, tspec, tp, tc


def test_pose_grid_matches_jax():
    times = np.array([-1.0, 0.25], np.float32)
    ref = np.asarray(JFT.pose_grid(jnp.asarray(times), H, W))
    got = TF.pose_grid(torch.from_numpy(times), H, W).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-7)
    assert TF.pose_grid(torch.zeros(1), 5, 6, 2).shape == (1, 5, 6, 2)


def test_flow_infer_matches_jax(models, video):
    jcfg, tcfg, spec, params, consts, tspec, tp, tc = models
    media = TM.FlowMedia(video, flow_scale=SCALE)
    times = media.times[:3]
    scale = np.float32(media.flow_scale)
    f12, f21 = JFT.make_flow_infer(spec, jcfg, None)(
        params, consts, None, jnp.asarray(times), jnp.asarray(scale), H, W)
    g12, g21 = TF.flow_infer(tspec, tp, tc, torch.from_numpy(times),
                             float(scale), H, W)
    for got, ref in ((g12, f12), (g21, f21)):
        assert got.shape == (3, H, W, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    assert float(np.abs(np.asarray(f12)).max()) > 1.0   # flows of pixels


@pytest.mark.parametrize("alpha", [0.5, 0.25])
def test_frame_interp_matches_jax(models, video, alpha):
    jcfg, tcfg, spec, params, consts, tspec, tp, tc = models
    media = TM.FlowMedia(video, flow_scale=SCALE)
    scale = np.float32(media.flow_scale)
    pair = video[1:3].astype(np.float32)
    ref = JFT.make_frame_interp(spec, jcfg, None)(
        params, consts, None, jnp.asarray(media.times[1]), jnp.asarray(pair),
        jnp.float32(alpha), jnp.asarray(scale))
    TG.reset_launch_counts()
    TK5.reset_launch_counts()
    got = TF.frame_interp(tspec, tcfg, tp, tc, float(media.times[1]),
                          torch.from_numpy(pair), alpha, float(scale))
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    # the CPU route takes the plain versions: no kernel launches
    assert TG.launch_counts() == {"gather_region": 0}
    assert TK5.launch_counts() == {"splat_region": 0}


def test_frame_interp_endpoints_exact(models, video):
    _, tcfg, _, _, _, tspec, tp, tc = models
    pair = torch.from_numpy(video[0:2].astype(np.float32))
    for alpha, want in ((0.0, pair[0]), (1.0, pair[1])):
        got = TF.frame_interp(tspec, tcfg, tp, tc, -1.0, pair, alpha, 8.0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_flow_test_outputs_match_jax(models, video, tmp_path):
    jcfg, tcfg, spec, params, consts, tspec, tp, tc = models
    gt = np.random.RandomState(0).randn(3, H, W, 2).astype(np.float32)
    media = TM.FlowMedia(video, gt, flow_scale=SCALE)
    out = TL.flow_test_outputs(tcfg.replace(test_batch=2), media, tspec, tp,
                               tc)
    f12, f21 = JFT.make_flow_infer(spec, jcfg, None)(
        params, consts, None, jnp.asarray(media.times[:3]),
        jnp.asarray(np.float32(media.flow_scale)), H, W)
    np.testing.assert_allclose(out["flow12"], np.asarray(f12), atol=1e-4)
    masks = np.asarray(JO.occlusion_wang(jnp.asarray(out["flow12"]), f21,
                                         tcfg.occl_thresh))
    assert out["masks"].shape == (3, H, W, 1)
    assert set(np.unique(out["masks"])) <= {0.0, 1.0}
    # the same flows through JAX's occlusion: masks flip only where a
    # coverage sits within rounding of the threshold
    assert np.mean(out["masks"] != masks) <= 2e-3
    # the mean of the per-batch EPEs (batches of 2 and 1 pairs), as in JAX
    ref_epe = np.mean([float(JFT.epe(f12[s], jnp.asarray(gt[s])))
                       for s in (slice(0, 2), slice(2, 3))])
    assert abs(out["epe"] - ref_epe) <= 1e-4


# ---------------------------------------------------------------------------
# Checkpoints, entry points and the CLI
# ---------------------------------------------------------------------------

def _cfg(tmp_path, **kw):
    return FlowConfig(**TINY, device="cpu",
                      results_dir=str(tmp_path / "results"),
                      checkpoints_dir=str(tmp_path / "checkpoints"), **kw)


def _save_checkpoint(cfg, scene, step=5):
    spec, params, consts = TI.build_inr(
        R.named_fold(R.root_generator(123), "init"), cfg.net, cfg)
    CheckpointStore(TL.flow_ckpt_dir(cfg, scene)).save(
        step, TL.flow_state_dict(params, consts, step))
    return spec, params, consts


def test_flow_restore_round_trip_and_refusals(tmp_path):
    cfg = _cfg(tmp_path)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        TL._flow_create_and_restore(cfg, R.root_generator(0), "clip",
                                    require="no checkpoint for clip")
    spec, params, consts = _save_checkpoint(cfg, "clip")
    _, rp, rc, _, step = TL._flow_create_and_restore(
        cfg, R.root_generator(0), "clip")
    assert step == 5
    for (ka, a), (kb, b) in zip(TI.flat_leaves({"p": params, "c": consts}),
                                TI.flat_leaves({"p": rp, "c": rc})):
        assert ka == kb and torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        TL._flow_create_and_restore(cfg.replace(hidden_dim=32),
                                    R.root_generator(0), "clip")
    with pytest.raises(ValueError, match="leaves"):
        TL._flow_create_and_restore(cfg.replace(num_layers=2),
                                    R.root_generator(0), "clip")


def test_run_flow_test_and_interpolate(tmp_path, video):
    cfg = _cfg(tmp_path)
    _save_checkpoint(cfg, "clip")
    media = TM.FlowMedia(video)
    res = TL.run_flow_test(cfg, media=media, scene="clip")
    assert res["num_frames"] == 3
    assert os.path.isfile(res["flow_path"]) and os.path.isfile(
        res["occl_path"])
    with open(tmp_path / "results" / "flow_clip_temp.json") as f:
        meta = json.load(f)
    assert meta["frames"] == 3 and meta["scene"] == "clip"

    res = TL.run_flow_interpolate(cfg, factor=3, media=media, scene="clip")
    assert res["num_frames"] == 10 and os.path.isfile(res["path"])
    with open(tmp_path / "results" / "interp_clip_temp_x3.json") as f:
        meta = json.load(f)
    assert meta["frames_in"] == 4 and meta["frames_out"] == 10
    import imageio.v2 as io
    assert len(io.mimread(res["path"])) == 10

    spec, params, consts, _, _ = TL._flow_create_and_restore(
        cfg, R.root_generator(0), "clip")
    frames = TL.interpolate_frames(cfg, media, spec, params, consts, 2)
    assert frames.shape == (7, H, W, 3) and frames.dtype == np.uint8
    np.testing.assert_array_equal(
        frames[::2], (np.clip(video, 0, 1) * 255).astype(np.uint8))
    with pytest.raises(ValueError):
        TL.interpolate_frames(cfg, media, spec, params, consts, 1)


def test_flow_serving_refuses_a_local_window_sidecar(tmp_path, video):
    """A net trained on local windows is not served on the static ones,
    which compute another function."""
    cfg = _cfg(tmp_path)
    _save_checkpoint(cfg, "clip")
    with open(os.path.join(TL.flow_ckpt_dir(cfg, "clip"),
                           "window_bounds.json"), "w") as f:
        json.dump({"fh": H, "fw": W, "splat_max_dy": 16, "splat_max_dx": 16,
                   "splat_local_dy": 8, "splat_local_dx": None}, f)
    media = TM.FlowMedia(video)
    for run in (TL.run_flow_test, TL.run_flow_interpolate):
        with pytest.raises(NotImplementedError, match="local windows"):
            run(cfg, media=media, scene="clip")


def test_flow_media_reads_frames_and_flo(tmp_path, video):
    import imageio.v2 as io
    frames = tmp_path / "frames" / "clip"
    frames.mkdir(parents=True)
    for i, f in enumerate((video * 255).astype(np.uint8)):
        io.imwrite(str(frames / f"frame_{i + 1:04d}.png"), f)
    flows = tmp_path / "flows"
    flows.mkdir()
    gt = np.random.RandomState(1).randn(3, H, W, 2).astype(np.float32)
    for i, f in enumerate(gt):
        TFLO.write_flo(str(flows / f"frame_{i + 1:04d}.flo"), f)
    _, media, scene = TM.get_video(str(frames), H, H, flow_dir=str(flows))
    assert scene == "clip" and media.video.shape == (4, H, W, 3)
    assert media.flow_scale == W / 5.0
    np.testing.assert_array_equal(media.flow, gt)
    np.testing.assert_allclose(media.video, (video * 255).astype(np.uint8)
                               / 255.0, atol=1e-6)


def test_flow_cli_end_to_end(tmp_path, video):
    import imageio.v2 as io
    frames = tmp_path / "frames" / "clip"
    frames.mkdir(parents=True)
    for i, f in enumerate((video * 255).astype(np.uint8)):
        io.imwrite(str(frames / f"frame_{i + 1:04d}.png"), f)
    cfg = FlowConfig(**TINY, device="cpu",
                     checkpoints_dir=str(tmp_path / "checkpoints"))
    _save_checkpoint(cfg, "clip")
    common = ["--input-video", str(frames), "--size", str(H), "--test-size",
              str(H), "--num-frequencies", "16", "--hidden-dim", "16",
              "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO)
    for op, extra in (("test", []), ("interpolate", ["--interp-factor",
                                                     "2"])):
        res = subprocess.run([sys.executable, "-m", "sin_inn_tpu_torch.cli",
                              "flow", op, *common, *extra],
                             capture_output=True, text=True, env=env,
                             cwd=str(tmp_path), timeout=120)
        assert res.returncode == 0, res.stderr
    results = tmp_path / "results"
    with open(results / "flow_clip_temp.json") as f:
        assert json.load(f)["frames"] == 3
    with open(results / "interp_clip_temp_x2.json") as f:
        assert json.load(f)["frames_out"] == 7
    assert (results / "occl_clip_temp.gif").is_file()


@pytest.mark.parametrize("operation", ["train", "export", "summarize",
                                       "sintel"])
def test_flow_cli_unported_operations_fail(operation, capsys):
    assert cli.main(["flow", operation, "--device", "cpu"]) == 2
    assert "not ported yet" in capsys.readouterr().err


def test_flow_cuda_request_without_card_raises(monkeypatch, tmp_path, video):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(tmp_path).replace(device="cuda")
    assert FlowConfig().device == "cuda"
    media = TM.FlowMedia(video)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.run_flow_test(cfg, media=media, scene="clip")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.run_flow_interpolate(cfg, media=media, scene="clip")

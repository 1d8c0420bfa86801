"""The port's serving path held against the JAX package: eval and infer
steps with the same z, the data pipeline, the checkpoint store, and
``run_sr_test`` / the ``sr test`` CLI end to end on the CPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import SRConfig as JaxSRConfig
from sin_inn_tpu.data import sr_video as JV
from sin_inn_tpu.data.synthetic import synthetic_sr_video as jax_synthetic
from sin_inn_tpu.models import inn as JI
from sin_inn_tpu.train import sr as JSR
from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.data import sr_video as TV
from sin_inn_tpu_torch.data.synthetic import synthetic_sr_video
from sin_inn_tpu_torch.models import inn as TI
from sin_inn_tpu_torch.models.convert import params_from_jax
from sin_inn_tpu_torch.train import loop as LP
from sin_inn_tpu_torch.train import sr as TSR
from torch_port_helpers import np_params
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(scale=2, lr_window=1, num_coupling=2, hidden_channels=16, fps=30)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxSRConfig(**TINY)
    tcfg = SRConfig(**TINY, device="cpu")
    jspec, _ = JI.build_inn_spec(jcfg)
    tspec, _ = TI.build_inn_spec(tcfg)
    params = np_params(jspec)
    return jcfg, tcfg, jspec, params, tspec, params_from_jax(tspec, params)


@pytest.fixture(scope="module")
def video():
    return synthetic_sr_video(SRConfig(**TINY, device="cpu"), h=16, w=16)


def test_synthetic_video_and_datasets_match_jax(video):
    tcfg = SRConfig(**TINY, device="cpu")
    jvid = jax_synthetic(JaxSRConfig(**TINY), h=16, w=16)
    np.testing.assert_array_equal(video.hr, jvid.hr)
    np.testing.assert_array_equal(video.lr, jvid.lr)
    for t, j in zip(TV.make_datasets(video, tcfg),
                    JV.make_datasets(jvid, JaxSRConfig(**TINY))):
        np.testing.assert_array_equal(t.indices, j.indices)
        sel = np.arange(min(3, len(t)))
        tb, jb = t.gather(sel), j.gather(sel)
        for k in ("hr", "lr"):
            np.testing.assert_array_equal(tb[k], jb[k])


def test_device_cache_keeps_uint8_batches(video):
    _, _, val = TV.make_datasets(video, SRConfig(**TINY, device="cpu"))
    cached = val.device_cache(3, "cpu")
    assert sum(b["hr"].shape[0] for b in cached) == len(val)
    assert cached[0]["lr"].dtype == torch.uint8
    np.testing.assert_array_equal(cached[0]["lr"].numpy(),
                                  val.gather(np.arange(3))["lr"])


def test_eval_step_matches_jax(models, video):
    """Same params, batch and z (drawn in JAX as its eval step draws it):
    metrics agree to rtol 1e-4."""
    jcfg, tcfg, jspec, jparams, tspec, tparams = models
    _, _, val = TV.make_datasets(video, tcfg)
    batch = val.gather(np.arange(len(val)))
    key = jax.random.key(5)
    jm = JSR.make_eval_step(jspec, jcfg)(
        jax.tree_util.tree_map(jnp.asarray, jparams),
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    b, h, w, _ = batch["lr"].shape
    z = np.array(jax.random.normal(key, (b, h, w, jcfg.z_dims), jnp.float32))
    tm = TSR.make_eval_step(tspec, tcfg)(tparams, TV.to_device(batch, "cpu"),
                                         z=torch.from_numpy(z))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)


def test_infer_step_matches_jax(models, video):
    """uint8 frames from the same z differ by at most 1 at rounding
    boundaries, on under 0.1% of values."""
    jcfg, tcfg, jspec, jparams, tspec, tparams = models
    _, unsup, _ = TV.make_datasets(video, tcfg)
    lr = unsup.gather(np.arange(len(unsup)))["lr"]
    key = jax.random.key(9)
    jf = np.asarray(JSR.make_infer_step(jspec, jcfg)(
        jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(lr), key))
    b, h, w, _ = lr.shape
    z = np.array(jax.random.normal(key, (b, h, w, jcfg.z_dims), jnp.float32))
    tf = TSR.make_infer_step(tspec, tcfg)(tparams, torch.from_numpy(lr),
                                          z=torch.from_numpy(z)).numpy()
    assert tf.dtype == np.uint8 and tf.shape == jf.shape
    diff = np.abs(tf.astype(np.int16) - jf.astype(np.int16))
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= 1e-3 * diff.size


def test_infer_step_draws_z_from_generator(models, video):
    _, tcfg, _, _, tspec, tparams = models
    _, unsup, _ = TV.make_datasets(video, tcfg)
    lr = torch.from_numpy(unsup.gather(np.arange(2))["lr"])
    infer = TSR.make_infer_step(tspec, tcfg)
    a = infer(tparams, lr, R.root_generator(3))
    b = infer(tparams, lr, R.root_generator(3))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        infer(tparams, lr)


def _save_fresh_state(cfg):
    gen = R.named_fold(R.root_generator(cfg.random_seed), "init")
    spec, state = TSR.create_state(gen, cfg)
    store = CheckpointStore(os.path.join(LP.sr_dirs(cfg, "train"),
                                         "checkpoints"))
    store.save(3, state.state_dict())
    return spec, state


def test_checkpoint_store_latest_scan(tmp_path):
    store = CheckpointStore(str(tmp_path / "ck"))
    assert store.restore() == (None, None)
    for step in (2, 10, 7):
        store.save(step, {"step": step, "w": torch.full((2,), float(step))})
    os.makedirs(tmp_path / "ck" / "step_0000000099")    # no state file
    assert store.latest_step() == 10
    state, step = store.restore()
    assert step == 10 and torch.equal(state["w"], torch.full((2,), 10.0))
    assert store.restore(step=7)[0]["step"] == 7


def test_restore_rejects_mismatched_checkpoint(tmp_path):
    cfg = SRConfig(**TINY, device="cpu", working_dir=str(tmp_path))
    _save_fresh_state(cfg)
    wider = cfg.replace(hidden_channels=8)
    with pytest.raises(ValueError):
        LP._sr_create_and_restore(wider, R.root_generator(0))
    with pytest.raises(FileNotFoundError):
        LP._sr_create_and_restore(
            cfg.replace(working_dir=str(tmp_path / "empty")),
            R.root_generator(0), require="no checkpoint")


def test_run_sr_test_from_port_checkpoint(tmp_path, video):
    cfg = SRConfig(**TINY, device="cpu", val_batch_size=4,
                   working_dir=str(tmp_path))
    spec, state = _save_fresh_state(cfg)
    out = LP.run_sr_test(cfg, video=video, save_images=True)
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    n = len(TV.all_indices(cfg, video.num_lr))
    assert len(pngs) == n
    frames = np.stack(list(LP.sr_test_frames(cfg, video, state, spec)))
    assert frames.shape == (n, 16, 16, 3) and frames.dtype == np.uint8
    import imageio.v2 as io
    np.testing.assert_array_equal(io.imread(os.path.join(out, pngs[0])),
                                  frames[0])


def _write_dataset(root, video, scene):
    import imageio.v2 as io
    for kind, frames in (("hr_frames", video.hr), ("lr_frames", video.lr)):
        d = os.path.join(root, kind, scene)
        os.makedirs(d)
        for i, f in enumerate(frames):
            io.imwrite(os.path.join(d, f"frame_{i + 1:04d}.png"), f)


def test_sr_test_cli_end_to_end(tmp_path, video):
    scene, work = "clip", str(tmp_path / "exp")
    _write_dataset(str(tmp_path / "data"), video, scene)
    cfg = SRConfig(**TINY, device="cpu", scene=scene, working_dir=work)
    _save_fresh_state(cfg)
    args = ["sr", "test", "--dataset", str(tmp_path / "data"), "-s", scene,
            "--scale", "2", "--lr_window", "1", "-c", "2",
            "--hidden_channels", "16", "-f", "30", "-w", work,
            "--val_batch_size", "4", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "sin_inn_tpu_torch.cli",
                          *args], capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=120)
    assert res.returncode == 0, res.stderr
    out = res.stdout.strip().splitlines()[-1]
    assert os.path.isfile(out) and os.path.getsize(out) > 0


def test_cuda_request_without_card_raises(monkeypatch, tmp_path, video):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SRConfig(**TINY, working_dir=str(tmp_path))
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSR.create_state(R.root_generator(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LP.run_sr_test(cfg, video=video)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LP.run_sr_train(cfg, video=video)

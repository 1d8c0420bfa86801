"""The port's tooling of ``sr train`` / ``flow train`` against the JAX
package on the CPU: the LR range test (per-LR scores within 1e-4 relative
of JAX's with the same init, carried over with ``models/convert.py``, and
the noise JAX draws; each loss within 1e-5 relative; the same LR picked),
the batch probe (stops only on ``torch.cuda.OutOfMemoryError``, releases
the failed probe's tensors, lets every other exception through), the
trace window (exactly N steps traced; none with N <= 0), the
``--profile`` traces of both training loops, wandb media through a stand-in
module, the new CLI flags, and the native loader bit for bit against numpy
and the JAX package's loader.
"""

import gc
import json
import os
import shutil
import sys
import weakref

import jax
import numpy as np
import pytest
import torch

from sin_inn_tpu.core.config import SRConfig as JaxSRConfig
from sin_inn_tpu.data import native as JN
from sin_inn_tpu.models import inn as JI
from sin_inn_tpu.train import sr as JSR
from sin_inn_tpu.train import tuner as JT
from sin_inn_tpu_torch import cli
from sin_inn_tpu_torch.core import profiler as P
from sin_inn_tpu_torch.core.config import FlowConfig, SRConfig
from sin_inn_tpu_torch.data import native as TN
from sin_inn_tpu_torch.data import sr_video as SV
from sin_inn_tpu_torch.data.flow_media import FlowMedia
from sin_inn_tpu_torch.data.synthetic import (moving_texture_video,
                                              synthetic_sr_video)
from sin_inn_tpu_torch.models import inn as TI
from sin_inn_tpu_torch.models.convert import params_from_jax
from sin_inn_tpu_torch.train import loop as L
from sin_inn_tpu_torch.train import sr as TSR
from sin_inn_tpu_torch.train import tuner as T
from test_torch_port_train import _jax_draws
from torch_port_helpers import one_torch_thread  # noqa: F401

TINY = dict(scale=2, lr_window=1, num_coupling=2, hidden_channels=16,
            fps=30)
HR, B = 16, 2


@pytest.fixture(scope="module")
def video():
    return synthetic_sr_video(SRConfig(**TINY, device="cpu"), h=HR, w=HR)


def _batch(video, b=B):
    sup, _, _ = SV.make_datasets(video, SRConfig(**TINY, device="cpu"))
    return sup.gather(np.arange(b) % len(sup))


# -- find_lr -----------------------------------------------------------------

def test_lr_scores_match_jax(video):
    """Each LR's losses within 1e-5 and score (first loss less last) within
    1e-4 relative of JAX's ``find_lr`` loop, and the same pick."""
    lrs, steps = [1e-5, 1e-4, 1e-3], 4
    jcfg = JaxSRConfig(**TINY, donate_state=False)
    tcfg = SRConfig(**TINY, device="cpu")
    key = jax.random.key(5)
    batch = _batch(video)
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    jspec, _ = JI.build_inn_spec(jcfg)
    tspec, _ = TI.build_inn_spec(tcfg)
    init = jax.tree_util.tree_map(np.asarray, JI.init_inn(key, jspec))

    ref = []       # sin_inn_tpu/train/tuner.py find_lr, loss by loss
    for lr in lrs:
        c = jcfg.replace(learning_rate=lr)
        spec, state, tx = JSR.create_train_state(key, c)
        step = JSR.make_train_step(spec, c, tx)
        losses = []
        for i in range(steps):
            state, aux = step(state, jbatch, None, jax.random.fold_in(key, i))
            losses.append(float(aux["loss"]))
        ref.append(losses)
    jpick = JT.find_lr(jcfg, jbatch, key, lrs=lrs, steps=steps)

    lo = HR // 4
    draws = [_jax_draws(jax.random.fold_in(jax.random.fold_in(key, i), i),
                        jcfg, B, lo, lo) for i in range(steps)]
    got = T.lr_scores(tcfg, SV.to_device(batch, "cpu"),
                      torch.Generator().manual_seed(0), lrs=lrs, steps=steps,
                      params=params_from_jax(tspec, init), draws=draws)
    for r, losses in zip(got, ref):
        assert r["steps"] == steps
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["score"], losses[0] - losses[-1],
                                   rtol=1e-4)
    pick = T.find_lr(tcfg, SV.to_device(batch, "cpu"),
                     torch.Generator().manual_seed(0), lrs=lrs, steps=steps,
                     params=params_from_jax(tspec, init), draws=draws)
    assert pick == jpick


def test_lr_scores_non_finite_loss_scores_minus_inf(video, monkeypatch):
    real = TSR.make_train_step

    def make(spec, cfg):
        step = real(spec, cfg)

        def run(state, *a, **kw):
            aux = step(state, *a, **kw)
            if cfg.learning_rate > 1e-4 and state.step == 2:
                aux = dict(aux, loss=torch.tensor(float("nan")))
            return aux
        return run

    monkeypatch.setattr(T.SR, "make_train_step", make)
    got = T.lr_scores(SRConfig(**TINY, device="cpu"),
                      SV.to_device(_batch(video), "cpu"),
                      torch.Generator().manual_seed(0), lrs=[1e-4, 1e-3],
                      steps=3)
    assert got[0]["steps"] == 3 and np.isfinite(got[0]["score"])
    assert got[1]["steps"] == 2 and got[1]["score"] == -np.inf
    assert T.find_lr(SRConfig(**TINY, device="cpu"),
                     SV.to_device(_batch(video), "cpu"),
                     torch.Generator().manual_seed(0), lrs=[1e-4, 1e-3],
                     steps=3) == 1e-4


# -- find_batch_size -----------------------------------------------------------

def _failing_step(monkeypatch, from_batch, exc, held):
    """Make every train step of batch >= ``from_batch`` raise ``exc`` while
    a local holds a tensor (``held`` gets a weak reference to it)."""
    real = TSR.make_train_step

    def make(spec, cfg):
        step = real(spec, cfg)

        def run(state, sup, *a, **kw):
            if sup["hr"].shape[0] >= from_batch:
                scratch = torch.zeros(1024)
                held.append(weakref.ref(scratch))
                raise exc("planted fault at batch "
                          f"{sup['hr'].shape[0]}")
            return step(state, sup, *a, **kw)
        return run

    monkeypatch.setattr(T.SR, "make_train_step", make)


def _make_batch(video):
    sup, _, _ = SV.make_datasets(video, SRConfig(**TINY, device="cpu"))
    return lambda b: SV.to_device(sup.gather(np.arange(b) % len(sup)), "cpu")


def test_find_batch_size_stops_on_out_of_memory(video, monkeypatch):
    held = []
    _failing_step(monkeypatch, 8, torch.cuda.OutOfMemoryError, held)
    cfg = SRConfig(**TINY, device="cpu")
    probes = T.batch_probes(cfg, _make_batch(video),
                            torch.Generator().manual_seed(0), start=2,
                            limit=64)
    assert [p["batch"] for p in probes] == [2, 4, 8]
    assert [p["error"] is None for p in probes] == [True, True, False]
    assert probes[-1]["error"].startswith("OutOfMemoryError: planted fault")
    # the failed probe's tensors were released with its traceback
    assert held and held[0]() is None
    assert T.find_batch_size(cfg, _make_batch(video),
                             torch.Generator().manual_seed(0), start=2,
                             limit=64) == 4
    # out of memory at the first batch: the start batch, as in JAX
    assert T.find_batch_size(cfg, _make_batch(video),
                             torch.Generator().manual_seed(0), start=8,
                             limit=64) == 8


@pytest.mark.parametrize("exc", [RuntimeError, ValueError])
def test_find_batch_size_lets_other_errors_through(video, monkeypatch, exc):
    """A kernel's launch fault or a shape error is not "out of memory"."""
    _failing_step(monkeypatch, 4, exc, [])
    with pytest.raises(exc, match="planted fault at batch 4"):
        T.find_batch_size(SRConfig(**TINY, device="cpu"), _make_batch(video),
                          torch.Generator().manual_seed(0), start=1,
                          limit=64)


def test_find_batch_size_stops_at_the_limit(video):
    probes = T.batch_probes(SRConfig(**TINY, device="cpu"),
                            _make_batch(video),
                            torch.Generator().manual_seed(0), start=1,
                            limit=4)
    assert [(p["batch"], p["error"], p["peak_bytes"]) for p in probes] == [
        (1, None, None), (2, None, None), (4, None, None)]


def test_run_sr_train_auto_batch_auto_lr_and_profile(tmp_path, video,
                                                    monkeypatch):
    picked = {}
    real_fb, real_lr = T.find_batch_size, T.find_lr

    def fb(cfg, make_batch, gen, start=1, limit=512):
        picked["start"] = start
        return real_fb(cfg, make_batch, gen, start=start, limit=4)

    def flr(cfg, batch, gen, **kw):
        picked["batch"] = int(batch["hr"].shape[0])
        picked["lr"] = real_lr(cfg, batch, gen, lrs=[1e-4, 1e-3], steps=2)
        return picked["lr"]

    monkeypatch.setattr(T, "find_batch_size", fb)
    monkeypatch.setattr(T, "find_lr", flr)
    cfg = SRConfig(**TINY, device="cpu", batch_size=2, epochs=3,
                   print_iter=10, save_iter=10, auto_batch=True,
                   auto_lr=True, profile_steps=1,
                   working_dir=str(tmp_path))
    out = L.run_sr_train(cfg, video=video)
    assert picked["start"] == 2 and picked["batch"] == 4
    assert out["cfg"].batch_size == 4
    assert out["cfg"].learning_rate == picked["lr"]
    assert out["state"].optimizer.param_groups[0]["lr"] == picked["lr"]
    assert out["trace"].startswith(os.path.join(out["exp_dir"],
                                                "checkpoints", "trace"))
    with open(out["trace"]) as f:
        assert json.load(f)["traceEvents"]


# -- profiler ----------------------------------------------------------------

class _FakeProfiler:
    def __init__(self, events):
        self.events = events

    def start(self):
        self.events.append("start")

    def stop(self):
        self.events.append("stop")


@pytest.mark.parametrize("n", [1, 2, 5])
def test_trace_window_traces_exactly_n_steps(monkeypatch, tmp_path, n):
    """The steps between the start (exclusive) and the stop (inclusive)."""
    events = []
    monkeypatch.setattr(P, "_profiler", lambda d: _FakeProfiler(events))
    monkeypatch.setattr(P, "_export", lambda prof, logdir, *a: "trace.json")
    tw = P.TraceWindow(str(tmp_path), n, warmup=2, device="cpu")
    traced = 0
    for _ in range(20):
        active = tw._prof is not None
        tw.tick()
        traced += active
    assert tw.done and events == ["start", "stop"]
    assert traced == n and tw.path == "trace.json"


def test_trace_window_off_and_close(monkeypatch, tmp_path):
    events = []
    monkeypatch.setattr(P, "_profiler", lambda d: _FakeProfiler(events))
    monkeypatch.setattr(P, "_export", lambda prof, logdir, *a: "trace.json")
    off = P.TraceWindow(str(tmp_path), 0, device="cpu")
    for _ in range(10):
        off.tick()
    off.close()
    assert off.done and events == [] and off.path is None
    # a run that ends inside the window writes what it traced
    tw = P.TraceWindow(str(tmp_path), 5, warmup=1, device="cpu")
    for _ in range(3):
        tw.tick()
    tw.close()
    assert events == ["start", "stop"] and tw.path == "trace.json"


@pytest.mark.parametrize("device, waits", [
    ("cuda", True), (torch.device("cuda", 0), True), ("cpu", False)])
def test_settle_waits_only_for_the_card(monkeypatch, device, waits):
    """A session on a CUDA device waits ``CUPTI_SETTLE_S`` after its start;
    one on the CPU does not wait."""
    slept = []
    monkeypatch.setattr(P.time, "sleep", slept.append)
    P.settle(device)
    assert slept == ([P.CUPTI_SETTLE_S] if waits else [])


def test_trace_context_writes_a_chrome_trace(tmp_path):
    with P.trace(str(tmp_path / "t"), device="cpu"):
        torch.ones(8).sum()
    (name,) = os.listdir(tmp_path / "t")
    assert name.endswith(".pt.trace.json")
    with open(tmp_path / "t" / name) as f:
        assert json.load(f)["traceEvents"]


def test_flow_train_profile_writes_a_trace(tmp_path):
    video = np.random.RandomState(0).rand(3, 12, 16, 3).astype(np.float32)
    cfg = FlowConfig(net="RBF", num_frequencies=8, hidden_dim=16,
                     num_layers=2, epochs=3, profile_steps=2, device="cpu",
                     checkpoints_dir=str(tmp_path / "ckpt"),
                     results_dir=str(tmp_path / "res"))
    out = L.run_flow_train(cfg, media=FlowMedia(video), scene="prof")
    trace_dir = tmp_path / "ckpt" / "prof" / "temp" / "trace"
    assert os.listdir(trace_dir) == [os.path.basename(out["trace"])]
    with open(out["trace"]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # the traced steps' operators: the INR's products and the optimizer
    assert {"aten::matmul", "Optimizer.step#Lamb.step"} <= names


# -- wandb media ---------------------------------------------------------------

class _FakeWandbRun:
    def __init__(self):
        self.logged = []

    def log(self, payload, step=None):
        self.logged.append((step, payload))

    def finish(self):
        pass


class _FakeWandb:
    """A wandb stand-in that records the Video / Image payloads."""

    def __init__(self):
        self.run = _FakeWandbRun()

    def init(self, **kw):
        return self.run

    class Video:
        def __init__(self, arr, fps=4, format=None):
            self.shape = arr.shape

    class Image:
        def __init__(self, arr):
            self.shape = arr.shape


def test_wandb_flow_media(monkeypatch, tmp_path):
    """flow train logs the source video and its GT flow, flow test the
    predicted flow and occlusion videos (past the training epochs) and a
    sidecar beside the flow GIF."""
    fake = _FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    frames = moving_texture_video(4, 8, 8)
    media = FlowMedia(frames, flow=np.zeros((3, 8, 8, 2), np.float32))
    cfg = FlowConfig(net="RBF", num_frequencies=8, hidden_dim=16,
                     num_layers=2, epochs=1, batch=3, device="cpu",
                     checkpoints_dir=str(tmp_path / "ck"),
                     results_dir=str(tmp_path / "res"))
    out = L.run_flow_train(cfg, media=media, scene="s", use_wandb=True,
                           val_media=media)
    keys = [k for _, payload in fake.run.logged for k in payload]
    assert "media/source" in keys and "media/gt_flow" in keys
    shapes = {k: v.shape for _, p in fake.run.logged for k, v in p.items()
              if hasattr(v, "shape")}
    assert shapes["media/source"] == (4, 3, 8, 8)

    res = L.run_flow_test(cfg, media=media, scene="s", spec=out["spec"],
                          params=out["state"].params, consts=out["consts"],
                          use_wandb=True)
    logged = [(s, k) for s, payload in fake.run.logged for k in payload]
    assert (cfg.epochs, "flow/s_temp") in logged
    assert (cfg.epochs, "occl/s_temp") in logged
    with open(res["flow_path"] + ".json") as f:
        assert json.load(f) == {"epe": res["epe"], "scene": "s"}


def test_wandb_sr_sample_media(monkeypatch, tmp_path, video):
    fake = _FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    cfg = SRConfig(**TINY, device="cpu", batch_size=4, val_batch_size=4,
                   epochs=1, save_iter=10, print_iter=1,
                   working_dir=str(tmp_path / "exp"))
    L.run_sr_train(cfg, video=video, use_wandb=True)
    keys = [k for _, payload in fake.run.logged for k in payload]
    assert "media/sample_hr" in keys and "loss" in keys


def test_cli_takes_the_tooling_flags():
    def grab(ns_to_cfg, argv):
        import argparse
        p = argparse.ArgumentParser()
        sub = p.add_subparsers(dest="command")
        cli._sr_parser(sub)
        cli._flow_parser(sub)
        return ns_to_cfg(p.parse_args(argv))

    sr = grab(cli.sr_config_from_args,
              ["sr", "train", "--auto_lr", "--auto_batch", "--profile", "3",
               "--wandb", "--device", "cpu"])
    assert (sr.auto_lr, sr.auto_batch, sr.profile_steps) == (True, True, 3)
    fl = grab(cli.flow_config_from_args,
              ["flow", "train", "--profile", "2", "--wandb",
               "--import-torch", "ref.ckpt", "--device", "cpu"])
    assert (fl.profile_steps, fl.import_torch) == (2, "ref.ckpt")


# -- the native loader --------------------------------------------------------

# decided without building: collection imports this module in every worker
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")


@needs_gxx
def test_native_builds_beside_the_port():
    lib = TN._target()
    assert lib.parent == TN.BUILD_DIR and lib.is_file()
    assert TN.SOURCE.name == "loader.cpp" and TN.SOURCE.parent.name == "native"


@needs_gxx
@pytest.mark.parametrize("c,t", [(4, 3), (4, 21), (1, 1)])
def test_native_gather_windows_bit_for_bit(c, t):
    rng = np.random.RandomState(c * 100 + t)
    lr = rng.randint(0, 256, (30, 5, 7, c), dtype=np.uint8)
    win = rng.randint(0, 30, (6, t)).astype(np.int64)
    out = TN.gather_windows(lr, win)
    ref = np.moveaxis(lr[win], 1, 3).reshape(6, 5, 7, t * c)
    np.testing.assert_array_equal(out, ref)
    if JN.available():
        np.testing.assert_array_equal(out, JN.gather_windows(lr, win))


@needs_gxx
def test_native_gather_frames_bit_for_bit():
    rng = np.random.RandomState(1)
    hr = rng.randint(0, 256, (6, 5, 7, 3), dtype=np.uint8)
    idx = np.asarray([4, 0, 2, 4], np.int64)
    out = TN.gather_frames(hr, idx)
    np.testing.assert_array_equal(out, hr[idx])
    if JN.available():
        np.testing.assert_array_equal(out, JN.gather_frames(hr, idx))
    with pytest.raises(IndexError):
        TN.gather_frames(hr, np.asarray([6]))


@needs_gxx
def test_native_prefetcher_covers_the_pass_in_order():
    rng = np.random.RandomState(2)
    n = 12
    lr = rng.randint(0, 256, (n, 4, 4, 4), dtype=np.uint8)
    hr = rng.randint(0, 256, (n, 8, 8, 3), dtype=np.uint8)
    samples = np.arange(2, 10)
    window = samples[:, None] + np.arange(-1, 2)[None, :]
    order = rng.permutation(len(samples))
    got = list(TN.Prefetcher(lr, hr, window, samples, order, batch=3))
    assert [b["hr"].shape[0] for b in got] == [3, 3, 2]
    np.testing.assert_array_equal(np.concatenate([b["hr"] for b in got]),
                                  hr[samples[order]])
    np.testing.assert_array_equal(
        np.concatenate([b["lr"] for b in got]),
        np.moveaxis(lr[window[order]], 1, 3).reshape(8, 4, 4, 12))
    if JN.available():
        ref = list(JN.Prefetcher(lr, hr, window, samples, order, batch=3))
        for a, b in zip(got, ref):
            for k in ("hr", "lr"):
                np.testing.assert_array_equal(a[k], b[k])


@needs_gxx
def test_dataset_gather_routes_and_prefetch(video, monkeypatch):
    cfg = SRConfig(**TINY, device="cpu")
    sup, _, _ = SV.make_datasets(video, cfg)
    sel = np.arange(len(sup))[::-1]
    SV.reset_gather_route_counts()
    native = sup.gather(sel)
    assert SV.gather_route_counts() == {"native": 1, "numpy": 0}
    monkeypatch.setattr(TN, "available", lambda: False)
    plain = sup.gather(sel)
    assert SV.gather_route_counts() == {"native": 1, "numpy": 1}
    assert sup.native_prefetch(2) is None
    monkeypatch.undo()
    for k in ("hr", "lr"):
        np.testing.assert_array_equal(native[k], plain[k])
    batch = next(sup.native_prefetch(len(sup), shuffle=False))
    ref = sup.gather(np.arange(len(sup)))
    for k in ("hr", "lr"):
        np.testing.assert_array_equal(batch[k], ref[k])
    gc.collect()

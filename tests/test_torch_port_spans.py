"""The port's spans and counters (``core/profiler.py``) on the CPU: off,
``span`` is one shared no-op and nothing is kept; on, spans nest with
their parent and unit ids on a stack per thread; the counters' registry
and the kernel modules' ``launch_counts`` / ``reset_launch_counts`` views
onto it; the clock offsets from anchor calls; ``TraceWindow`` and the
``--profile`` traces of both training loops carry the spans nested in
their N steps on the trace's clock; ``flow_test_outputs`` waits for the
device once a call, whatever its queries, moves the bytes its queries need
and opens its layer spans, and gives what a loop of its queries gives, in
arrays of its own each call. The card's clock is checked in
``tests/test_torch_port_cuda.py``."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sin_inn_tpu_torch.core import profiler as P
from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.core.config import FlowConfig, SRConfig
from sin_inn_tpu_torch.data.flow_media import FlowMedia
from sin_inn_tpu_torch.data.synthetic import (moving_texture_video,
                                              synthetic_sr_video)
from sin_inn_tpu_torch.ops.cuda import coupling as K
from sin_inn_tpu_torch.ops.cuda import coupling3x3 as K8
from sin_inn_tpu_torch.ops.cuda import gather as K6
from sin_inn_tpu_torch.ops.cuda import inr as K7
from sin_inn_tpu_torch.ops.cuda import splat as K5
from sin_inn_tpu_torch.train import flow as FT
from sin_inn_tpu_torch.train import loop as L
from torch_port_helpers import flow_test_per_query
from torch_port_helpers import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def spans_off():
    P.collect_spans()
    yield
    P.collect_spans()


def _tree(spans):
    return {s.id: s for s in spans}


# -- spans --------------------------------------------------------------------

def test_spans_off_record_nothing_and_share_one_no_op():
    a, b = P.span("driver.sr_step"), P.span("step.loss")
    assert a is b
    with a, b:
        pass
    assert P.collect_spans() == []


def test_spans_nest_with_parent_and_unit_ids():
    P.enable_spans()
    with P.span("driver.flow_step"):
        with P.span("step.loss"):
            with P.span("model.inr"):
                pass
            with P.span("flow_ops.photometric"):
                pass
        with P.span("step.backward"):
            pass
    with P.span("data.to_host"):
        pass
    spans = P.collect_spans()
    assert P.span("x") is P.span("y")          # off again
    names = [s.name for s in spans]
    assert names == ["model.inr", "flow_ops.photometric", "step.loss",
                     "step.backward", "driver.flow_step", "data.to_host"]
    by = {s.name: s for s in spans}
    root, loss = by["driver.flow_step"], by["step.loss"]
    assert root.parent == 0 and root.unit == root.id
    assert loss.parent == root.id and by["step.backward"].parent == root.id
    assert by["model.inr"].parent == loss.id
    assert {s.unit for s in spans[:5]} == {root.id}
    assert by["data.to_host"].unit == by["data.to_host"].id != root.id
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent:
            p = _tree(spans)[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_spans_keep_a_stack_per_thread():
    """A span opened on another thread while one is open on the main thread
    is a root of its own, on that thread."""
    P.enable_spans()
    opened, release = threading.Event(), threading.Event()

    def worker():
        with P.span("worker.outer"):
            opened.set()
            release.wait(5)
            with P.span("worker.inner"):
                pass

    with P.span("main.outer"):
        t = threading.Thread(target=worker)
        t.start()
        opened.wait(5)
        with P.span("main.inner"):
            pass
        release.set()
        t.join()
    by = {s.name: s for s in P.collect_spans()}
    main, other = threading.get_native_id(), t.native_id
    assert by["main.inner"].parent == by["main.outer"].id
    assert by["worker.inner"].parent == by["worker.outer"].id
    assert by["worker.outer"].parent == 0
    assert by["worker.outer"].unit == by["worker.outer"].id
    assert {by["main.outer"].thread, by["main.inner"].thread} == {main}
    assert {by["worker.outer"].thread, by["worker.inner"].thread} == {other}


def test_enable_spans_starts_afresh():
    P.enable_spans()
    with P.span("a"):
        pass
    P.enable_spans()
    with P.span("b"):
        pass
    assert [s.name for s in P.collect_spans()] == ["b"]
    assert P.collect_spans() == []


# -- counters -----------------------------------------------------------------

def test_counters_count_read_and_reset_by_prefix():
    P.reset_counters("test.")
    P.count("test.a")
    P.count("test.a", 4)
    P.count("test.b.x", 2)
    P.count("test.b.y")
    c = P.counters()
    assert (c["test.a"], c["test.b.x"], c["test.b.y"]) == (5, 2, 1)
    c["test.a"] = 99                      # a copy
    assert P.counters()["test.a"] == 5
    P.reset_counters("test.b.")
    assert {k: v for k, v in P.counters().items()
            if k.startswith("test.")} == {"test.a": 5}
    P.reset_counters(("test.a", "test.z"))
    assert not any(k.startswith("test.") for k in P.counters())


def test_counters_lose_no_count_across_threads():
    """Eight threads counting one name 20,000 times each, switching every
    microsecond: every count is kept (the backward's launches are counted
    on the autograd engine's threads)."""
    P.reset_counters("test.threads")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(20_000):
                P.count("test.threads")
        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in ts)
    assert P.counters()["test.threads"] == 8 * 20_000
    P.reset_counters("test.threads")


@pytest.mark.parametrize("mod, names", [
    (K, ["fused_glow_forward_1x1", "fused_glow_inverse_1x1",
         "fused_glow_backward_1x1", "fused_glow_inverse_backward_1x1",
         "reduce_weight_grads"]),
    (K8, ["half_coupling_3x3", "half_coupling_3x3_backward"]),
    (K5, ["splat_region", "splat_region_local"]),
    (K6, ["gather_region", "gather_region_grads", "gather_region_local",
          "gather_region_local_grads"]),
    (K7, ["fused_inr_forward", "fused_inr_backward"]),
])
def test_launch_counts_are_views_onto_the_registry(mod, names):
    """Each module's ``launch_counts()`` keeps its keys and zeros and reads
    the registry's ``launches.<kernel>``; ``reset_launch_counts()`` zeroes
    its own kernels alone."""
    mod.reset_launch_counts()
    assert mod.launch_counts() == dict.fromkeys(names, 0)
    P.count("launches.unrelated_kernel", 3)
    for i, n in enumerate(names):
        P.count(f"launches.{n}", i + 1)
    assert mod.launch_counts() == {n: i + 1 for i, n in enumerate(names)}
    mod.reset_launch_counts()
    assert mod.launch_counts() == dict.fromkeys(names, 0)
    assert P.counters()["launches.unrelated_kernel"] == 3
    P.reset_counters("launches.unrelated_kernel")


# -- one clock ----------------------------------------------------------------

def _anchor_event(ts, dur, cat="user_annotation", name=P.ANCHOR):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _stamps(t0_ns):
    """A group's host stamps: one call, 1 ms, then seven back to back, each
    30 us of host time."""
    out, t = [], t0_ns
    for i in range(P.ANCHORS):
        if i == 1:
            t += int(P.ANCHOR_GAP_S * 1e9)
        out.append((t, t + 30_000))
        t += 31_000
    return out


@pytest.mark.parametrize("cat, name", [
    ("user_annotation", P.ANCHOR), ("cuda_runtime", "cudaDeviceSynchronize")])
def test_clock_offsets_put_each_anchor_call_inside_its_stamps(cat, name):
    """The trace's clock runs 1000 us ahead of the host's at the start and
    1004 us at the end; each call's event takes 3 us, 12-27 us into its 30
    us of stamps. The runtime events hold two more synchronises, one just
    before the first group and one just after the last (the profiler's
    own), which the gap tells from the anchors; a lone annotation does not
    take the runtime events' place."""
    first, last = _stamps(10_000), _stamps(900_000_000)
    ev = []
    for i, ((a, b), off) in enumerate([(s, 1000.0) for s in first]
                                      + [(s, 1004.0) for s in last]):
        ev.append(_anchor_event(a / 1e3 + off + 12.0 + i % 13, 3.0, cat,
                                name))
    if cat == "cuda_runtime":
        ev.append(_anchor_event(5.0, 1.0))
        ev.append(_anchor_event(first[0][0] / 1e3 + 950.0, 3.0, cat, name))
        ev.append(_anchor_event(last[-1][1] / 1e3 + 1030.0, 3.0, cat, name))
    o0, o1 = P.clock_offsets(ev, first, last)
    # the tightest calls bound each offset to within a few us
    assert abs(o0 - 1000.0) <= 5.0 and abs(o1 - 1004.0) <= 5.0
    edges = (first[0][0], last[-1][1])
    assert P.to_trace_us(edges[0], (o0, o1), edges) == \
        pytest.approx(edges[0] / 1e3 + o0)
    mid = (edges[0] + edges[1]) // 2
    assert P.to_trace_us(mid, (o0, o1), edges) == \
        pytest.approx(mid / 1e3 + (o0 + o1) / 2)


def test_anchor_group_waits_after_its_first_call():
    stamps = P.anchor("cpu")
    assert len(stamps) == P.ANCHORS
    assert stamps[1][0] - stamps[0][1] >= P.ANCHOR_GAP_S * 1e9
    assert all(a <= b for a, b in stamps)


def test_clock_offsets_need_the_anchor_calls():
    with pytest.raises(RuntimeError, match="anchor"):
        P.clock_offsets([_anchor_event(1.0, 1.0)], [(0, 1)] * 3,
                        [(2, 3)] * 3)


def _program_spans(path):
    with open(path) as f:
        doc = json.load(f)
    ev = doc["traceEvents"]
    spans = [e for e in ev if e.get("cat") == P.SPAN_CAT]
    ops = [e for e in ev if e.get("cat") == "cpu_op"]
    return doc, spans, ops


def _nested(spans):
    """Each span lies inside its parent, on the same thread's row."""
    by = {e["args"]["id"]: e for e in spans}
    for e in spans:
        p = by.get(e["args"]["parent"])
        if p is not None:
            assert p["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"]
            assert p["tid"] == e["tid"]


@pytest.mark.parametrize("n", [1, 3])
def test_trace_window_writes_its_steps_spans_on_the_trace_clock(tmp_path,
                                                                n):
    """The spans of the N traced steps, and no others, land in the trace,
    nested, each around its step's operator (2 ms from either edge)."""
    tw = P.TraceWindow(str(tmp_path), n, warmup=1, device="cpu")
    x = torch.ones(64)
    for i in range(n + 4):
        with P.span("driver.sr_step"):
            with P.span("step.loss"):
                time.sleep(0.002)
                x = x + float(i)
                time.sleep(0.002)
        tw.tick()
    tw.close()
    doc, spans, ops = _program_spans(tw.path)
    steps = [e for e in spans if e["name"] == "driver.sr_step"]
    assert len(steps) == n and len(spans) == 2 * n
    _nested(spans)
    adds = [e for e in ops if e["name"] == "aten::add"]
    assert len(adds) == n
    for s, op in zip(sorted(steps, key=lambda e: e["ts"]),
                     sorted(adds, key=lambda e: e["ts"])):
        assert s["ts"] <= op["ts"] and op["ts"] + op["dur"] <= s["ts"] + \
            s["dur"]
    assert len(doc["spanClockOffsetsUs"]) == 2


def test_trace_context_writes_the_blocks_spans(tmp_path):
    with P.trace(str(tmp_path), device="cpu"):
        with P.span("data.batch"):
            torch.ones(8).sum()
    (path,) = tmp_path.iterdir()
    _, spans, _ = _program_spans(path)
    assert [e["name"] for e in spans] == ["data.batch"]
    assert P.span("x") is P.span("y")


def test_sr_train_profile_trace_holds_the_step_spans(tmp_path):
    cfg = SRConfig(scale=2, lr_window=1, num_coupling=2, hidden_channels=16,
                   fps=30, device="cpu", batch_size=2, epochs=4,
                   print_iter=10, save_iter=10, profile_steps=2,
                   working_dir=str(tmp_path))
    video = synthetic_sr_video(cfg, h=16, w=16)
    out = L.run_sr_train(cfg, video=video)
    _, spans, _ = _program_spans(out["trace"])
    steps = [e for e in spans if e["name"] == "driver.sr_step"]
    assert len(steps) == 2
    _nested(spans)
    by = {e["args"]["id"]: e for e in spans}
    for e in spans:
        if e["name"] == "driver.sr_step":
            continue
        assert by[e["args"]["unit"]]["name"] == "driver.sr_step"
    names = [e["name"] for e in spans]
    assert {n: names.count(n) for n in set(names)} == {
        "driver.sr_step": 2, "data.batch": 2, "step.loss": 2,
        "model.inn": 4, "step.backward": 2, "step.optimizer": 2}
    parent = lambda e: by[e["args"]["parent"]]["name"]
    assert {parent(e) for e in spans if e["name"] == "model.inn"} == {
        "step.loss"}


def test_flow_train_profile_trace_holds_the_step_spans(tmp_path):
    video = moving_texture_video(4, 12, 16, seed=1)
    cfg = FlowConfig(net="RBF", num_frequencies=8, hidden_dim=16,
                     num_layers=2, epochs=2, profile_steps=2, device="cpu",
                     checkpoints_dir=str(tmp_path / "ckpt"),
                     results_dir=str(tmp_path / "res"))
    out = L.run_flow_train(cfg, media=FlowMedia(video), scene="prof")
    _, spans, _ = _program_spans(out["trace"])
    _nested(spans)
    names = [e["name"] for e in spans]
    assert {n: names.count(n) for n in set(names)} == {
        "driver.flow_step": 2, "step.loss": 2, "model.inr": 2,
        "flow_ops.photometric": 2, "step.backward": 2,
        "step.optimizer": 2, "step.controller": 2}


# -- flow_test_outputs -------------------------------------------------------

H, W = 12, 16


@pytest.fixture(scope="module")
def flow_model():
    cfg = FlowConfig(net="RBF", num_frequencies=8, hidden_dim=16,
                     num_layers=2, device="cpu")
    spec, params, consts, _, _ = FT.build_flow_model(R.root_generator(0),
                                                     cfg, "cpu")
    return cfg, spec, params, consts


@pytest.mark.parametrize("frames, batch", [(7, 2), (7, 4), (9, 8)])
def test_flow_test_outputs_wait_once_a_call(flow_model, frames, batch):
    """Times and GT to the device, the EPEs, the flows and the masks back,
    queued without a wait: one wait a call, and the bytes each moved."""
    cfg, spec, params, consts = flow_model
    video = moving_texture_video(frames, H, W, seed=2)
    gt = np.random.RandomState(3).randn(frames - 1, H, W, 2).astype(
        np.float32)
    media = FlowMedia(video, gt)
    P.reset_counters(("host_syncs", "h2d_bytes", "d2h_bytes"))
    P.enable_spans()
    out = L.flow_test_outputs(cfg.replace(test_batch=batch), media, spec,
                              params, consts)
    spans = P.collect_spans()
    c = P.counters()
    pairs = frames - 1
    queries = -(-pairs // batch)
    assert c["host_syncs"] == 1
    assert c["h2d_bytes"] == pairs * 4 + gt.nbytes
    assert c["d2h_bytes"] == queries * 4 + out["flow12"].nbytes + \
        out["masks"].nbytes
    names = [s.name for s in spans]
    assert names.count("driver.flow_query") == queries
    for n in ("data.batch", "model.inr", "flow_ops.epe",
              "flow_ops.occlusion"):
        assert names.count(n) == queries, n
    # a flow and a mask copy queued a query, and the call's one wait
    assert names.count("data.to_host") == 2 * queries + 1
    by = _tree(spans)
    for s in spans:
        if s.name not in ("driver.flow_query", "data.to_host"):
            assert by[s.unit].name == "driver.flow_query", s.name


def test_flow_test_outputs_without_gt_wait_once_a_call(flow_model):
    cfg, spec, params, consts = flow_model
    media = FlowMedia(moving_texture_video(5, H, W, seed=2))
    P.reset_counters(("host_syncs", "h2d_bytes", "d2h_bytes"))
    out = L.flow_test_outputs(cfg.replace(test_batch=2), media, spec,
                              params, consts)
    assert out["epe"] is None and out["flow12"].shape == (4, H, W, 2)
    c = P.counters()
    assert c["host_syncs"] == 1
    assert c["h2d_bytes"] == 4 * 4
    assert c["d2h_bytes"] == out["flow12"].nbytes + out["masks"].nbytes


@pytest.mark.parametrize("frames, batch", [(7, 2), (7, 3), (9, 8), (5, 8)])
@pytest.mark.parametrize("with_gt", [True, False])
def test_flow_test_outputs_are_a_loop_of_its_queries(flow_model, frames,
                                                     batch, with_gt):
    """Bitwise what a loop of the same queries gives (``FT.flow_infer``,
    ``occlusion_wang``, ``FT.epe``), with batches that divide the pairs and
    batches that do not; a second call returns arrays of its own and leaves
    the first call's as they were."""
    cfg, spec, params, consts = flow_model
    cfg = cfg.replace(test_batch=batch)
    gt = (np.random.RandomState(3).randn(frames - 1, H, W, 2).astype(
        np.float32) if with_gt else None)
    media = FlowMedia(moving_texture_video(frames, H, W, seed=2), gt)
    flows, masks, epe = flow_test_per_query(cfg, media, spec, params, consts)
    first = L.flow_test_outputs(cfg, media, spec, params, consts)
    kept = {k: first[k].copy() for k in ("flow12", "masks")}
    assert np.array_equal(first["flow12"], flows)
    assert np.array_equal(first["masks"], masks)
    assert first["epe"] == epe
    second = L.flow_test_outputs(cfg, media, spec, params, consts)
    for k in ("flow12", "masks"):
        assert not np.shares_memory(first[k], second[k]), k
        assert np.array_equal(first[k], kept[k]), k
        assert np.array_equal(second[k], kept[k]), k
    assert second["epe"] == epe

"""The span session's attribution (``harness/spans.py``) on synthetic
intervals: the window cut by the innermost open span, the idle stretches
split piecewise among them, ``outside`` where no span is open, and shares
that add up to the idle share; and the ``idle.*`` / ``host_syncs.*``
readers on a session and without one."""

import random

import pytest

from harness import core, spans
from harness.spans import OUTSIDE, SpanSession, attribute, segments
from harness.tiny import bench
from harness.trace import _merge

# a step from 10 to 90: its loss 10-40 (the model 15-30 inside it), its
# backward 40-70, its optimizer 70-85; a second unit 92-98
SPANS = [(10.0, 90.0, "driver.sr_step"), (10.0, 40.0, "step.loss"),
         (15.0, 30.0, "model.inn"), (40.0, 70.0, "step.backward"),
         (70.0, 85.0, "step.optimizer"), (92.0, 98.0, "data.to_host")]


def test_segments_follow_the_innermost_span():
    assert segments(SPANS, 0.0, 100.0) == [
        (0.0, 10.0, OUTSIDE), (10.0, 15.0, "step.loss"),
        (15.0, 30.0, "model.inn"), (30.0, 40.0, "step.loss"),
        (40.0, 70.0, "step.backward"), (70.0, 85.0, "step.optimizer"),
        (85.0, 90.0, "driver.sr_step"), (90.0, 92.0, OUTSIDE),
        (92.0, 98.0, "data.to_host"), (98.0, 100.0, OUTSIDE)]


def test_segments_clip_to_the_window():
    assert segments(SPANS, 20.0, 50.0) == [
        (20.0, 30.0, "model.inn"), (30.0, 40.0, "step.loss"),
        (40.0, 50.0, "step.backward")]
    assert segments([], 0.0, 5.0) == [(0.0, 5.0, OUTSIDE)]


def test_idle_is_split_piecewise_by_the_innermost_span():
    # busy 0-12, 20-25, 28-60 (two overlapping kernels), 80-95
    busy = [(0.0, 12.0), (20.0, 25.0), (28.0, 60.0), (80.0, 95.0)]
    got = attribute(busy, SPANS, 0.0, 100.0)
    # idle: 12-20 (loss 12-15, model 15-20), 25-28 (model), 60-80
    # (backward 60-70, optimizer 70-80), 95-100 (to_host 95-98, outside)
    assert got == pytest.approx({"step.loss": 3.0, "model.inn": 8.0,
                                 "step.backward": 10.0,
                                 "step.optimizer": 10.0,
                                 "data.to_host": 3.0, OUTSIDE: 2.0})


def test_no_span_is_all_outside_and_no_idle_is_nothing():
    assert attribute([(0.0, 50.0)], [], 0.0, 200.0) == {OUTSIDE: 75.0}
    assert attribute([(-5.0, 300.0)], SPANS, 0.0, 200.0) == {}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_shares_add_up_to_the_idle_share(seed):
    """Random nested spans and kernels: the names' shares add up to the
    window's idle share within 0.1 point (to rounding, in fact), and each
    name's share is at most its segments' share of the window."""
    rng = random.Random(seed)
    t0, t1 = 0.0, 10_000.0
    nested, t = [], 0.0
    while t < t1:
        a = t + rng.uniform(0, 50)
        b = a + rng.uniform(10, 400)
        nested.append((a, b, "driver.sr_step"))
        c = a + rng.uniform(0, (b - a) / 3)
        d = c + rng.uniform(0, (b - c) / 2)
        nested.append((c, d, rng.choice(["step.loss", "step.backward"])))
        if d - c > 2:
            nested.append((c + 1, d - 1, "model"))
        t = b
    kernels = sorted((s, s + rng.uniform(1, 60)) for s in
                     (rng.uniform(t0 - 50, t1) for _ in range(400)))
    busy = _merge(kernels)
    idle = sum(b - a for a, b in spans.idle_gaps(busy, t0, t1))
    got = attribute(busy, nested, t0, t1)
    assert abs(sum(got.values()) - 100.0 * idle / (t1 - t0)) < 0.1
    room = {}
    for a, b, n in segments(nested, t0, t1):
        room[n] = room.get(n, 0.0) + 100.0 * (b - a) / (t1 - t0)
    assert all(v <= room[k] + 1e-9 for k, v in got.items())


class _Run:
    def __init__(self, session, trace=object()):
        self.trace = trace
        if session is not None:
            self.span_session = session


def _session():
    return SpanSession({"model.inn": 4.0, "step.backward": 7.5,
                        "step.optimizer": 1.25, "model.inr": 2.0,
                        "flow_ops.photometric": 3.0,
                        "flow_ops.occlusion": 0.5, "flow_ops.epe": 0.25,
                        "data.batch": 6.0, "data.to_host": 9.0,
                        OUTSIDE: 1.0},
                       {"host_syncs": 0.625})


WANT = {"idle.model.sr_train": 4.0, "idle.backward.sr_train": 7.5,
        "idle.optimizer.sr_train": 1.25, "idle.model.flow_train": 2.0,
        "idle.flow_ops.flow_train": 3.0, "idle.backward.flow_train": 7.5,
        "idle.optimizer.flow_train": 1.25, "idle.model.flow_test": 2.75,
        "idle.data.flow_test": 15.0, "host_syncs.flow_test": 0.625}


def test_the_readers_read_their_spans_and_counter():
    names = {m["name"] for m in bench()["per_layer"]}
    assert set(WANT) <= names
    for name, want in WANT.items():
        assert core.metric_reader(name)(_Run(_session())) == \
            pytest.approx(want), name


def test_the_readers_read_nothing_without_a_session():
    """Untraced, or a program without spans: None, and no session runs;
    a session where none of the names held the card idle: 0."""
    for name in WANT:
        assert core.metric_reader(name)(_Run(None, trace=None)) is None
        assert core.metric_reader(name)(_Run(SpanSession(
            {OUTSIDE: 3.0}, {}))) == 0.0
    absent = _Run(None)
    absent.span_session = None            # the program had no spans
    assert all(core.metric_reader(n)(absent) is None for n in WANT)

"""Nothing the harness runs loads JAX or the JAX package, and the reference
loads nothing of the program (whole top-level module names compared: the
port's name begins with the JAX package's)."""

import subprocess
import sys

from harness import core

BENCH = core.BENCH_DIR
ROOT = BENCH.parent

PROBE = """
import sys, json
sys.path[:0] = [{bench!r}, {root!r}]
import importlib
for m in {mods!r}:
    importlib.import_module(m)
from harness import core
for name in {metrics!r}:
    core.metric_reader(name)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(mods, metrics=()):
    code = PROBE.format(bench=str(BENCH), root=str(ROOT), mods=list(mods),
                        metrics=list(metrics))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    import json
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_and_entries_load_no_jax():
    from harness.tiny import bench
    metrics = [m["name"] for m in bench()["per_layer"]]
    mods = ["harness.core", "harness.trace", "harness.synth",
            "harness.weights", "harness.compare", "cost", "entries.sr_train",
            "entries.flow_train", "entries.flow_test",
            "sin_inn_tpu_torch.train.loop", "sin_inn_tpu_torch.train.sr",
            "sin_inn_tpu_torch.train.flow"]
    tops = _top_level(mods, metrics)
    assert not tops & set(core.FORBIDDEN), tops & set(core.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    tops = _top_level(["reference.srf", "reference.flow",
                       "reference.precision"])
    assert not tops & (set(core.FORBIDDEN) | {"sin_inn_tpu_torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sin_inn_tpu_torch_fake", sys)
    assert "sin_inn_tpu_torch_fake" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib.fake" in core.forbidden_modules()

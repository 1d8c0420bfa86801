"""Each cell run once on the card, short, untraced and traced: exit 0, a
result line of the contract's keys, ``correct`` true. Marked ``cuda``; it
skips without a card (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from harness import core
from harness.tiny import bench

ROOT = core.BENCH_DIR.parent


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload",
                         [w["name"] for w in bench()["workloads"]])
def test_cell_runs_on_the_card(workload, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        workload, "--seed", str(2 ** 31 + 3), "--seconds",
                        "2", "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]

"""The benchmark's cells at sizes a CPU can hold, for the tests and for
``tools/readings.py --cpu-tiny``: every width cut, every path the same."""

from __future__ import annotations

import copy
import json

from harness import core

TINY_CONFIG = {
    "srf-4x": {"scale": 2, "lr_window": 1, "hidden_channels": 16,
               "hr_height": 32, "hr_width": 64, "batch_size": 2},
    "flow-rbf-sintel": {"num_frequencies": 128, "hidden_dim": 256,
                        "height": 32, "width": 64},
}
TINY_TRAFFIC = {
    "sr-train-b8": {"frames": 83, "warm_steps": 1, "trace_units": 2},
    "flow-train-b3": {"frames": 7, "batch": 2, "warm_steps": 1,
                      "trace_units": 2,
                      "motion": {"kx": 0.05, "ky": 0.05, "tx": 1.0,
                                 "ty": 1.0, "period": 4}},
    "flow-test-b8": {"frames": 7, "test_batch": 2, "warm_passes": 1,
                     "trace_units": 1,
                     "motion": {"kx": 0.05, "ky": 0.05, "tx": 1.0,
                                "ty": 1.0, "period": 4}},
}


def bench() -> dict:
    with open(core.BENCH_DIR.parent / "BENCHMARK.json") as f:
        return json.load(f)


def full_cell(workload: str) -> core.Cell:
    """A cell of BENCHMARK.json at its own size."""
    return core.resolve(bench(), workload, core.BENCH_DIR.parent)


def tiny_cell(workload: str) -> core.Cell:
    cell = copy.deepcopy(full_cell(workload))
    cell.config.update(TINY_CONFIG[cell.workload["config"]])
    cell.traffic.update(TINY_TRAFFIC[cell.workload["traffic"]])
    return cell

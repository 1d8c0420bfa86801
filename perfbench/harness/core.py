"""One run of one cell: resolve it by name, set it up, measure the window,
trace a slice (``--trace 1``), free the program's state, compare with the
reference, and build the result line.

Everything particular to a cell is found by name: the configuration's file
(``BENCHMARK.json``'s ``file``), the traffic file
``perfbench/traffic/<traffic>.json`` and its entry module
``perfbench/entries/<entry>.py``, the limits file
``perfbench/limits/<workload>.json``, and one module per per-layer metric,
``perfbench/metrics/<metric>.py``, whose ``read(run)`` returns its number
or None when it finds nothing to read.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "sin_inn_tpu")


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    d = hashlib.blake2b(f"{int(seed)}/{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(d, "little") & (2 ** 63 - 1)


@dataclass
class Cell:
    workload: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def resolve(bench: Dict, name: str, root: Path) -> Cell:
    """The cell ``name`` of a parsed ``BENCHMARK.json`` whose checkout is
    ``root``."""
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    mine = lambda m: name in m.get("workloads", [name])
    return Cell(wl, _json(root / conf["file"]),
                _json(BENCH_DIR / "traffic" / f"{wl['traffic']}.json"),
                _json(BENCH_DIR / "limits" / f"{name}.json"),
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def entry_module(kind: str):
    return importlib.import_module(f"entries.{kind}")


def metric_reader(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's, Flax's or the
    JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclass
class Run:
    """What a metric reader reads: the cell, the entry, the window's units
    and seconds, and the traced slice of the device's activity."""
    cell: Cell
    entry: object
    units: int = 0
    window_s: float = 0.0
    trace: object = None


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Phases:
    """Seconds of each named part of a set-up, each ended by a synchronise
    (printed on standard error before the checks)."""

    def __init__(self, device):
        self.device, self.t, self.items = device, time.perf_counter(), []

    def mark(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.items.append((name, now - self.t))
        self.t = now


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> Tuple[Dict, List, Run]:
    """Set up, run the window (and the traced slice), release the
    program's state and compare. Returns (result, checks, run)."""
    flags = cell.config.get("precision", {})
    torch.backends.cuda.matmul.allow_tf32 = bool(flags.get("matmul_tf32"))
    torch.backends.cudnn.allow_tf32 = bool(flags.get("cudnn_tf32"))
    entry = entry_module(cell.traffic["entry"]).Cell(cell.config,
                                                     cell.traffic, seed, device)
    entry.setup()
    gc.collect()
    sync(device)
    setup_s = time.perf_counter() - t_start

    units = 0
    t0 = time.perf_counter()
    while True:
        units += entry.unit()
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    run = Run(cell, entry, units, window_s)

    metrics: Dict[str, Dict] = {}
    result: Dict = {}
    if trace:
        from harness import trace as T
        n = int(cell.traffic["trace_units"])
        run.trace = T.device_slice(entry.unit, n)
        for m in cell.per_layer:
            v = metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = T.breakdown(T.host_slice(entry.unit, n),
                                          run.trace)
    else:
        rate = units / window_s
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics[m["name"]] = {"value": setup_s, "unit": "s"}
            else:
                metrics[m["name"]] = {"value": rate, "unit": m["unit"]}

    is_cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    entry.release()
    numbers = dict(entry.check())
    missing = set(cell.limits) - set(numbers)
    if missing:
        raise KeyError(f"the check gave no {sorted(missing)}")
    checks = [(name, numbers[name], float(lim))
              for name, lim in cell.limits.items()]
    correct = all(v <= lim for _, v, lim in checks) and len(checks) > 0
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
           "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    result = {"correct": correct, "attempted": units, "failed": 0,
              "metrics": metrics, "device": dev, **result,
              "checks": {n: {"value": v, "limit": lim}
                         for n, v, lim in checks}}
    return result, checks, run

"""The readings that a cell's limits are set from, many seeds in one
process (the build, the imports and the first launches paid once).

    python3 perfbench/tools/readings.py --workload W --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds 10] [--out readings.jsonl]

from the root of a checkout, on the card (``--cpu-tiny``: a rehearsal on
the CPU at the tests' tiny sizes). For each seed it reads (see
``harness/controls.py``):

* ``program``: the numbers of a run of the cell (set-up with its checked
  steps, for a serving cell ``--seconds`` of its units) against the fp32
  reference;
* ``control`` (the control seeds): the same numbers of the control in the
  program's place;
* ``half_batch`` (training cells, the control seeds): the reference over
  the first half of each checked batch against the whole one.

Each reading is one JSON line; the summary gives per number the largest
program reading and the smallest control and fault readings.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

from harness import controls, core  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu-tiny", action="store_true")
    args = ap.parse_args()
    root = Path.cwd()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    device, cell = "cuda", core.resolve(bench, args.workload, root)
    if args.cpu_tiny:
        from harness.tiny import tiny_cell
        device, cell = "cpu", tiny_cell(args.workload)
    flags = cell.config.get("precision", {})
    torch.backends.cuda.matmul.allow_tf32 = bool(flags.get("matmul_tf32"))
    torch.backends.cudnn.allow_tf32 = bool(flags.get("cudnn_tf32"))
    rows = []

    def emit(kind, seed, nums, t0):
        row = {"workload": args.workload, "kind": kind, "seed": seed,
               "numbers": nums, "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")

    seeds = lambda s: [int(x) for x in s.split(",") if x]
    for s in seeds(args.seeds):
        t0 = time.perf_counter()
        _, nums = controls.program_numbers(copy.deepcopy(cell), s,
                                           args.seconds, device)
        emit("program", s, nums, t0)
    for s in seeds(args.control_seeds):
        t0 = time.perf_counter()
        e, nums = controls.control_numbers(copy.deepcopy(cell), s,
                                           args.seconds, device)
        emit("control", s, nums, t0)
        if cell.traffic["entry"] in ("sr_train", "flow_train"):
            t0 = time.perf_counter()
            emit("half_batch", s, controls.half_batch_numbers(
                e, controls.batch_rows(cell)), t0)
        del e
    for n in sorted({k for r in rows for k in r["numbers"]}):
        for kind, agg in (("program", max), ("control", min),
                          ("half_batch", min)):
            v = [r["numbers"][n] for r in rows if r["kind"] == kind]
            if v:
                print(f"summary {args.workload} {n} {kind} "
                      f"{'max' if agg is max else 'min'} {agg(v)!r} "
                      f"all {v}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

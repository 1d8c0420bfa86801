"""Run one cell several times, one process a run, and summarise the runs.

    python3 perfbench/tools/sets.py --workload W --seeds 11,12,13 \
        --seconds 10 [--trace 0] [--out runs.jsonl]

from the root of a checkout. Each run is ``perfbench/run.py`` with its own
seed; its result line, exit code and the end of its standard error go to
``--out`` as one JSON line. The summary prints, for each metric, every
value, the median and the spread (the distance between the first and the
third quartile of ``statistics.quantiles(values, n=4)``, as a share of the
median).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                            args.workload, "--seed", str(seed), "--seconds",
                            str(args.seconds), "--trace", str(args.trace)],
                           capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines else None
        except ValueError:
            res = None
        row = {"workload": args.workload, "seed": seed, "rc": p.returncode,
               "wall_s": wall, "result": res, "stderr": p.stderr[-3000:]}
        rows.append(row)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        short = {k: round(v["value"], 4) for k, v in
                 (res or {}).get("metrics", {}).items()}
        print(f"seed {seed} rc {p.returncode} wall {wall:.1f}s correct "
              f"{(res or {}).get('correct')} {short} checks "
              f"{(res or {}).get('checks')}", flush=True)
        if res is None:
            print(p.stderr[-3000:], flush=True)
    vals = {}
    for r in rows:
        for k, v in ((r["result"] or {}).get("metrics") or {}).items():
            vals.setdefault(k, []).append(v["value"])
    for k, v in vals.items():
        print(f"{args.workload} {k}: n {len(v)} median "
              f"{statistics.median(v):.6g} spread {spread(v)} values {v}")
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

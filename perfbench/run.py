"""Run one cell of the benchmark of ``sin_inn_tpu_torch`` once.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout holding ``BENCHMARK.json``. Needs as many CUDA
cards as the cell asks for; without them it exits 2 and prints no result.
The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared with the reference, each
beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    root = Path.cwd()
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    # the program under test is imported from the checkout
    sys.path.insert(1, str(root))
    import torch

    from harness import core
    cell = core.resolve(bench, args.workload, root)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks, run = core.measure(cell, args.seed, args.seconds,
                                       bool(args.trace), "cuda", T_START)
    bad = core.forbidden_modules()
    if bad:
        print("perfbench: modules of JAX or of the JAX package were loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    for name, seconds in getattr(run.entry, "phases", core.Phases("cpu")).items:
        print(f"setup {name} {seconds:.3f} s", file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())

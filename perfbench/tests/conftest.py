"""Tests of the benchmark harness, run on the CPU (``python -m pytest
perfbench/tests -q`` from the repository root); those marked ``cuda`` (the
marker of ``pyproject.toml``) need a card and skip without one: on the card,
``python -m pytest perfbench/tests -m cuda -q``."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p in sys.path:
        sys.path.remove(p)
sys.path[:0] = [str(BENCH), str(ROOT)]

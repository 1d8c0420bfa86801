"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files."""

import json
import re
import subprocess
import sys

import pytest

from harness import core
from harness.tiny import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
ROOT = core.BENCH_DIR.parent


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells = 24
    total = ((2 + 14 * cells) * (b["run_seconds"] + 60) + cells * 2 * 90
             + 1200)
    assert total <= 43200


def test_names_and_units():
    b = bench()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)


def test_entry_keys():
    b = bench()
    want = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, keys in want.items():
        for e in b[group]:
            extra = set(e) - keys
            assert set(e) >= keys and extra <= {"workloads"}, (group, e)


def test_end_to_end_metrics():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in b["workloads"]:
        mine = [m for m in b["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert any(m["name"] == "setup_s" for m in mine)
        assert len(mine) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in b["per_layer"])


def test_per_layer_metrics_resolve():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        reports = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reports and set(m["workloads"]) <= cells
        assert callable(core.metric_reader(m["name"]))


def test_cells_resolve_to_their_files():
    b = bench()
    used = set()
    for w in b["workloads"]:
        cell = core.resolve(b, w["name"], ROOT)
        used.add(w["config"])
        assert callable(core.entry_module(cell.traffic["entry"]).Cell)
        assert set(cell.limits) and all(isinstance(v, (int, float))
                                        for v in cell.limits.values())
    assert used == {c["name"] for c in b["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configs_files():
    b = bench()
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert data["source"] == c["source"] and _line(c["source"])
        assert data["precision"]["dtype"] == "float32"


def test_four_chip_cells_are_few():
    b = bench()
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_run_fails_without_a_card():
    """On a machine without CUDA the run exits non-zero and prints no
    result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "srf-train-b8", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "CUDA" in p.stderr

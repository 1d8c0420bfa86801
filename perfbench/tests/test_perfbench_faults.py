"""A whole run of each cell at a tiny size on the CPU (the harness's look
for a card skipped): sound, it comes out correct; with each fault the cell
can have planted in its timed path, and with the control in the program's
place, it does not."""

import time

import pytest

from harness import controls, core
from harness.tiny import tiny_cell

CELLS = ("srf-train-b8", "flow-rbf-train-b3", "flow-rbf-test-b8")
SEED = 2 ** 31 + 11


def _run(workload):
    cell = tiny_cell(workload)
    result, checks, _ = core.measure(cell, SEED, 0.3, False, "cpu",
                                     time.perf_counter())
    return result


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = _run(workload)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS
    for f in controls.FAULTS[tiny_cell(w).traffic["entry"]]])
def test_planted_fault_is_not_correct(workload, fault):
    with controls.plant(tiny_cell(workload).traffic["entry"], fault):
        result = _run(workload)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_separates_at_a_small_size(workload):
    """At a size the CPU holds the control's errors are smaller than at the
    cell's (the cell's limits are for the cell's size: the card test below
    holds the control to them); it still reads three times the program's
    reading or more on one of the compared numbers."""
    cell = tiny_cell(workload)
    _, prog = controls.program_numbers(cell, SEED, 0.3, "cpu")
    _, ctl = controls.control_numbers(cell, SEED, 0.3, "cpu")
    assert any(ctl[k] >= 3 * max(prog[k], 1e-12) for k in cell.limits), (
        prog, ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit_at_the_cell_size(workload):
    """The control on the card at the cell's own size, three seeds: each
    fails one of the cell's limits."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from harness.tiny import full_cell
    cell = full_cell(workload)
    flags = cell.config.get("precision", {})
    torch.backends.cuda.matmul.allow_tf32 = bool(flags.get("matmul_tf32"))
    torch.backends.cudnn.allow_tf32 = bool(flags.get("cudnn_tf32"))
    for seed in (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23):
        _, nums = controls.control_numbers(cell, seed, 10.0, "cuda")
        assert any(nums[k] > lim for k, lim in cell.limits.items()), nums

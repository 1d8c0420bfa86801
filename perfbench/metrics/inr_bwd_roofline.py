"""inr_bwd_roofline: K7 backward's (``ops/cuda/inr.py``,
``csrc/inr_bwd.cu``) share of its roofline in the traced slice, in %: its
launches (one fixed-order reduction each) times max(FLOP / TF32 peak,
bytes / HBM rate) of ``inr_backward_cost`` over the step's points
(``batch`` x 436 x 1024), over the device time of its kernels (the
per-chunk preparation, the row products, the weight stage, the reduction,
the weight packing)."""

from cost import inr_backward_cost, inr_widths, roofline_s
from harness.trace import count, group_time_s, symbol

SYMBOLS = ("prep_kernel", "row_gemm_kernel", "weight_stage_kernel",
           "reduce_partials_kernel", "pack_kernel")


def read(run):
    if run.trace is None:
        return None
    cfg = run.cell.config
    n = run.cell.traffic["batch"] * cfg["height"] * cfg["width"]
    launches = count(run.trace, symbol("reduce_partials_kernel"))
    spent = group_time_s(run.trace, SYMBOLS)
    if launches <= 0 or spent <= 0:
        return None
    return 100.0 * launches * roofline_s(
        *inr_backward_cost(n, inr_widths(cfg))) / spent

"""coupling_1x1_roofline: the fused 1x1 GLOW coupling kernels'
(K1-K4, ``ops/cuda/coupling.py``, ``csrc/coupling_1x1*.cu``) share of their
roofline in the traced slice, in %: the sum over their launches of
max(FLOP / TF32 peak, bytes / HBM rate), over the device time of every
kernel of theirs. A launch is counted by its main kernel (K1 / K2 the
coupling kernel, K3 / K4 the first of the four row phases), its shape is
the config's: each pass runs its 1x1 couplings in order, so the launches of
a kind take the couplings' shapes in equal shares."""

from cost import backward_cost, coupling_cost, roofline_s, srf_1x1_launches
from harness.trace import count, group_time_s

KINDS = {
    "K1": (r"coupling_1x1_kernel<float, false", coupling_cost, {}),
    "K2": (r"coupling_1x1_kernel<float, true", coupling_cost, {}),
    "K3": (r"row_phase_kernel<float, false, 0", backward_cost,
           {"inverse": False}),
    "K4": (r"row_phase_kernel<float, true, 0", backward_cost,
           {"inverse": True}),
}
SYMBOLS = ("coupling_1x1_kernel", "row_phase_kernel", "weight_stage_kernel",
           "reduce_partials_kernel", "pack_kernel")


def read(run):
    if run.trace is None:
        return None
    cfg = run.cell.config
    shapes = srf_1x1_launches(cfg, cfg["batch_size"])
    hidden = cfg["hidden_channels"]
    ideal = 0.0
    for pattern, fn, kw in KINDS.values():
        n = count(run.trace, pattern)
        per = sum(roofline_s(*fn(m, c, hidden, 4, **kw)) for m, c in shapes)
        ideal += n * per / len(shapes)
    spent = group_time_s(run.trace, SYMBOLS)
    if ideal <= 0 or spent <= 0:
        return None
    return 100.0 * ideal / spent

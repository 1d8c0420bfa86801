"""mfu.sr_train: the model FLOP of the window's units (``cost``), over the
window's seconds and the card's dense TF32 peak, in %."""

from cost import PEAK_TF32


def read(run):
    if run.units <= 0 or run.window_s <= 0:
        return None
    return 100.0 * run.entry.model_flops(run.units) / run.window_s / PEAK_TF32

"""idle.flow_ops.flow_train: the share of the span session's window, in %, in
which the card was idle while the innermost span open on the main thread
was ``flow_ops.photometric``: the warps, splats, L1, census, SSIM and
smoothness of the loss (``harness/spans.py``)."""

from harness.spans import idle_share


def read(run):
    return idle_share(run, "flow_ops.photometric")

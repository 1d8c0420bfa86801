"""idle.model.flow_test: the share of the span session's window, in %, in
which the card was idle while the innermost span open on the main thread
was ``model.inr``, ``flow_ops.occlusion`` or ``flow_ops.epe``: the INR
query, the occlusion mask and the EPE (``harness/spans.py``)."""

from harness.spans import idle_share


def read(run):
    return idle_share(run, "model.inr", "flow_ops.occlusion",
                      "flow_ops.epe")

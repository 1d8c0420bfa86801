"""idle.backward.sr_train: the share of the span session's window, in %, in
which the card was idle while the innermost span open on the main thread
was ``step.backward``: the loss's ``backward()`` (``harness/spans.py``)."""

from harness.spans import idle_share


def read(run):
    return idle_share(run, "step.backward")

"""idle.optimizer.sr_train: the share of the span session's window, in %, in
which the card was idle while the innermost span open on the main thread
was ``step.optimizer``: the gradient sync and Adam's step
(``harness/spans.py``)."""

from harness.spans import idle_share


def read(run):
    return idle_share(run, "step.optimizer")

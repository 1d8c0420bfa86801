"""idle.data.flow_test: the share of the span session's window, in %, in which
the card was idle while the innermost span open on the main thread was
``data.batch`` or ``data.to_host``: a query's batch slicing and copies to
the card, the copies of flows and masks back and their concatenation
(``harness/spans.py``)."""

from harness.spans import idle_share


def read(run):
    return idle_share(run, "data.batch", "data.to_host")

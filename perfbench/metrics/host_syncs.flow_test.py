"""host_syncs.flow_test: the times a pair that the program's loops and
data layers made the host wait for the card in the span session (the
program's ``host_syncs`` counter over the session's units, which are
pairs; ``harness/spans.py``)."""

from harness.spans import per_unit


def read(run):
    return per_unit(run, "host_syncs")

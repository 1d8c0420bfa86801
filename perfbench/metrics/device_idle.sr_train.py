"""device_idle.sr_train: the share of the traced slice, in %, in which the
card ran no kernel, copy or memset (a torch.profiler session of CUDA
activity alone, over the host clock's span of the traced units)."""

from harness.trace import idle_percent


def read(run):
    return None if run.trace is None else idle_percent(run.trace)

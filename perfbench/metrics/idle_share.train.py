"""``idle_share.train``: the share of a step's wall time in which no device
operation ran: the union of the kernel, copy and set intervals in the
profiler's trace of the traced steps, over the untraced window's
seconds a step, in %."""

from perfbench.readers import idle_share


def read(ctx):
    return idle_share(ctx, "train")

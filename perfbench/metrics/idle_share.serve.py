"""``idle_share.serve``: the share of a batch's wall time in which no device
operation ran: the union of the kernel, copy and set intervals in the
profiler's trace of the traced batches, over the untraced window's
seconds a batch, in %."""

from perfbench.readers import idle_share


def read(ctx):
    return idle_share(ctx, "serve")

"""``mfu.serve``: the model FLOPs of the window's batches, counted by
``perfbench/flops.py``, over the window's time and the H100's dense
bf16 peak, in %."""

from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx, "serve")

"""``b4_roofline.serve``: the share of its roofline that kernel B4, RMSNorm
(``rmsnorm_regs``, ``_wide``, ``_generic``) reaches in the traced
batches, in %: the least time those batches need in its launches (each
launch's operations over the peak or its bytes over the bandwidth,
whichever is larger, from the shapes the configuration and the traffic
fix: ``perfbench/flops.py``) over the time its kernels took in the
trace."""

from perfbench.readers import roofline


def read(ctx):
    return roofline(ctx, "b4", "serve")

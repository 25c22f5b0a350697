"""``b2_roofline.train``: the share of its roofline that kernel B2, flash
attention (``flash_wgmma`` and its backward ``flash_bwd_*``) reaches in
the traced steps, in %: the least time those steps need in its launches
(each launch's operations over the peak or its bytes over the bandwidth,
whichever is larger, from the shapes the configuration and the traffic
fix: ``perfbench/flops.py``) over the time its kernels took in the
trace."""

from perfbench.readers import roofline


def read(ctx):
    return roofline(ctx, "b2", "train")

"""What the per-layer metrics' readers share: a share of the chip's peak
over the window, the device's idle share of the traced window, and a
kernel family's roofline share in the trace.  Each returns None where
there is nothing to read, never 0 for a share."""

from __future__ import annotations

from perfbench import flops, profiling


def mfu(ctx, kind: str):
    """Model FLOPs of the window's units over the window's time and the
    chip's peak, in %."""
    if ctx.traffic["kind"] != kind or not ctx.units:
        return None
    work = ctx.units * flops.unit_flops(ctx.model, ctx.traffic)
    return 100.0 * work / (ctx.window_s * flops.PEAK_FLOPS)


def idle_share(ctx, kind: str):
    """The share of a unit's wall time in which no device operation ran,
    in %: the device's busy seconds a unit in the trace (the union of
    its kernel, copy and set intervals) over the untraced window's
    seconds a unit, since the profiler's own host work stretches the
    traced units' wall time (not their device time)."""
    if ctx.traffic["kind"] != kind or ctx.trace is None or not ctx.units:
        return None
    busy = profiling.busy_s(ctx.trace) / ctx.trace_units
    return 100.0 * (1.0 - busy / (ctx.window_s / ctx.units))


def roofline(ctx, family: str, kind: str):
    """The least time the traced units need in ``family``'s launches
    over the time its kernels took, in %; None where the trace has no
    such launch or the units need none."""
    if ctx.traffic["kind"] != kind or ctx.trace is None:
        return None
    need = ctx.trace_units * flops.kernel_bound_s(ctx.model, ctx.traffic,
                                                  family)
    took, launches = profiling.kernel_s(ctx.trace, flops.KERNELS[family])
    if not launches or need <= 0.0:
        return None
    return 100.0 * need / took

"""On the card: the trace reduction finds the port's kernels B2, B3 and
B4 (forward and backward) by the names ``perfbench/flops.py`` matches,
and its busy time lies inside the traced window.  Skips without a CUDA
device; run on the card with ``python -m pytest -q -m cuda
perfbench/tests``."""

from __future__ import annotations

import pytest
import torch

from perfbench import flops, profiling


@pytest.mark.cuda
def test_kernel_names_in_a_trace():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm_fused
    from repro_torch.kernels.ssd_scan import ssd_scan_op

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16).requires_grad_(True)

    q, k, v = rand(2, 4, 128, 64), rand(2, 2, 128, 64), rand(2, 2, 128, 64)
    x, gamma = rand(256, 512), rand(512)
    xs, b, c = rand(2, 256, 8, 64), rand(2, 256, 1, 64), rand(2, 256, 1, 64)
    dt = torch.rand(2, 256, 8, device=dev, generator=g).requires_grad_(True)
    a_log = torch.zeros(8, device=dev)

    def body():
        out = flash_attention(q, k, v, causal=True).float().sum()
        out = out + rmsnorm_fused(x, gamma, 1e-5).float().sum()
        y, _ = ssd_scan_op(xs, dt, a_log, b, c, 128)
        (out + y.float().sum()).backward()

    body()
    trace = profiling.traced(body, lambda: torch.cuda.synchronize(dev))
    assert 0 < profiling.busy_s(trace) <= trace.window_s
    for family in ("b2", "b3", "b4"):
        seconds, launches = profiling.kernel_s(trace, flops.KERNELS[family])
        assert launches >= 2 and seconds > 0, family

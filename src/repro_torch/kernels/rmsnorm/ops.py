"""Fused RMSNorm: the CUDA wrapper and its plain PyTorch version.

Counterpart of ``repro/kernels/rmsnorm``: ``y = x * rsqrt(mean(x**2) +
eps) * gamma`` over the last axis, in float32, cast once to ``x``'s
dtype.  ``x`` is float32 or bfloat16 of any leading shape; ``gamma`` is
``[D]``, float32 or bfloat16.

On the card the kernel takes one of two routes (:func:`route`): the
register route, which holds a row in registers and reads it once, where
D is a multiple of 16 bytes' worth of values, at most 16 such vectors
per lane (D <= 4,096 in bf16, D <= 2,048 in float32), and x and gamma are
16-byte aligned; else the generic two-pass route.  The register route
sums in the order of the generic route's 16-byte loop, so on aligned rows
the two give the same bits; the generic route's one-value loop (unaligned
rows, D not a multiple of the vector) sums in another order and agrees
to one bf16 ulp.

:func:`rmsnorm_fused` runs the plain version only for tensors on the
CPU (which only the tests pass).  For CUDA tensors it launches the
kernel of ``csrc/rmsnorm.cu`` on the current stream or raises; any other
device raises, and so does a CUDA call that would need a gradient (the
kernel has no backward yet: :mod:`repro_torch.kernels._route`).  It
counts its launches in ``rmsnorm_fused.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._route import launches_kernel
from repro_torch.kernels.rmsnorm.build import LIB

DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """The reference ``rmsnorm_ref``: float32 math, one cast at the end."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def rmsnorm_fused(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """``x``: ``[..., D]``; ``gamma``: ``[D]``.  Returns a new tensor of
    ``x``'s shape and dtype."""
    if x.dtype not in DTYPES or gamma.dtype not in DTYPES:
        raise ValueError(f"rmsnorm: want float32 or bfloat16, got x "
                         f"{x.dtype}, gamma {gamma.dtype}")
    if x.dim() < 1 or gamma.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm: gamma {tuple(gamma.shape)} does not "
                         f"match x {tuple(x.shape)}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm: x and gamma must be contiguous")
    if gamma.device != x.device:
        raise ValueError(f"rmsnorm: gamma on {gamma.device}, x on {x.device}")
    if not launches_kernel("rmsnorm", x, gamma):
        return rmsnorm_plain(x, gamma, eps)
    d = x.shape[-1]
    if d == 0 or d >= 2**31:
        raise ValueError(f"rmsnorm: D = {d} out of range")
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    err = LIB.load().rmsnorm(
        x.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows, d, float(eps),
        int(x.dtype == torch.bfloat16), int(gamma.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm: CUDA error {err}")
    rmsnorm_fused.launches += 1
    return out


rmsnorm_fused.launches = 0


def route(x: torch.Tensor, gamma: torch.Tensor) -> tuple:
    """The route :func:`rmsnorm_fused` takes on the card for these
    CUDA tensors, launching nothing: ``("register", kV, warps)`` with kV
    16-byte vectors per lane, or ``("generic", 0, warps)``; ``warps`` is
    rows per block.  Assumes an output from PyTorch's allocator (16-byte
    aligned), as the wrapper makes."""
    d = x.shape[-1]
    code = LIB.load().rmsnorm_route(
        x.data_ptr(), gamma.data_ptr(), None, x.numel() // d, d,
        int(x.dtype == torch.bfloat16))
    kv, warps = divmod(code, 256)
    return ("register" if kv else "generic", kv, warps)

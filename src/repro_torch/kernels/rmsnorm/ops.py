"""Fused RMSNorm: the CUDA wrappers of the forward and the backward, their
plain PyTorch versions, and the autograd Function that joins them.

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

:func:`rmsnorm_fused` returns through :class:`RMSNormFunction`, whose
forward runs the kernel of ``csrc/rmsnorm.cu`` and whose backward runs
:func:`rmsnorm_bwd`, the kernels of ``csrc/rmsnorm_bwd.cu`` (``dx`` and
``dgamma``, recomputing ``r``).  Each wrapper runs its plain version
only for tensors on the CPU (which only the tests pass); for CUDA
tensors it launches its kernel on the current stream or raises, and any
other device raises.  No path on a CUDA tensor reaches a plain version.
The wrappers count their launches in ``rmsnorm_fused.launches`` and
``rmsnorm_bwd.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._route import launches_kernel
from repro_torch.kernels.rmsnorm.build import LIB

DTYPES = (torch.float32, torch.bfloat16)
#: the widest row the backward kernel takes (its block's partial dgamma
#: lives in shared memory, 4 bytes a column)
MAX_BWD_D = 56000


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """The reference ``rmsnorm_ref``: float32 math, one cast at the end."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def rmsnorm_bwd_plain(x: torch.Tensor, gamma: torch.Tensor,
                      dy: torch.Tensor, eps: float = 1e-5) -> tuple:
    """The gradient of :func:`rmsnorm_plain` by the explicit formula, in
    float32: with ``r = rsqrt(mean(x**2) + eps)``, ``dx = r * (gamma *
    dy) - x * r**3 * mean(x * gamma * dy)`` in ``x``'s dtype and
    ``dgamma = sum over rows of dy * x * r`` in ``gamma``'s."""
    x32, dy32 = x.float(), dy.float()
    r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    gdy = gamma.float() * dy32
    c = (x32 * gdy).mean(-1, keepdim=True) * r.pow(3)
    dx = r * gdy - x32 * c
    dgamma = (dy32 * (x32 * r)).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dgamma.to(gamma.dtype)


class RMSNormFunction(torch.autograd.Function):
    """B4 with its gradient: the forward kernel forward and the backward
    kernel backward on the card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return _forward(x, gamma, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma = rmsnorm_bwd(x, gamma, dy.contiguous(), ctx.eps)
        return dx, dgamma, None


def rmsnorm_fused(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """``x``: ``[..., D]``; ``gamma``: ``[D]``.  Returns a new tensor of
    ``x``'s shape and dtype, differentiable in ``x`` and ``gamma``."""
    _check(x, gamma)
    return RMSNormFunction.apply(x, gamma, float(eps))


def _check(x: torch.Tensor, gamma: torch.Tensor) -> None:
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


def _forward(x: torch.Tensor, gamma: torch.Tensor,
             eps: float) -> torch.Tensor:
    """The forward kernel on the card, the plain version on the CPU."""
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


def rmsnorm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5) -> tuple:
    """``(dx, dgamma)`` of :func:`rmsnorm_fused` at ``x``, ``gamma`` for
    the output gradient ``dy`` (``x``'s shape and dtype, contiguous):
    the kernels of ``csrc/rmsnorm_bwd.cu`` on the card (one launch of the
    row kernel and one of the dgamma reduction, counted once), the plain
    version on the CPU."""
    _check(x, gamma)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"does not match x {tuple(x.shape)} {x.dtype}, or "
                         f"is not contiguous")
    if dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: dy on {dy.device}, x on {x.device}")
    if not launches_kernel("rmsnorm_bwd", x, gamma, dy):
        return rmsnorm_bwd_plain(x, gamma, dy, eps)
    lib = LIB.load()
    d = x.shape[-1]
    if d == 0 or d > MAX_BWD_D:
        raise ValueError(f"rmsnorm_bwd: D = {d}; the kernel takes 1 to "
                         f"{MAX_BWD_D}")
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(gamma)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = min(rows, 4 * sms)
    part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    dgamma = torch.empty_like(gamma)
    err = lib.rmsnorm_bwd(
        x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dgamma.data_ptr(), part.data_ptr(), rows, d, float(eps),
        int(x.dtype == torch.bfloat16), int(gamma.dtype == torch.bfloat16),
        blocks, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm_bwd: CUDA error {err}")
    rmsnorm_bwd.launches += 1
    return dx, dgamma


rmsnorm_bwd.launches = 0


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

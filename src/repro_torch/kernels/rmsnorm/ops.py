"""Fused RMSNorm: the CUDA wrappers of the forward and the backward, their
plain PyTorch versions, and the autograd Function that joins them.

Counterpart of ``repro/kernels/rmsnorm``: ``y = x * rsqrt(mean(x**2) +
eps) * gamma`` over the last axis, in float32, cast once to ``x``'s
dtype.  ``x`` is float32 or bfloat16 of any leading shape; ``gamma`` is
``[D]``, float32 or bfloat16.

On the card the kernel takes one of three routes (:func:`route`): the
register route, which holds a row in one warp's registers and reads it
once, where D is a multiple of 16 bytes' worth of values, at most 16 such
vectors per lane (D <= 4,096 in bf16, D <= 2,048 in float32), and x,
gamma and out are 16-byte aligned; the wide route, for such rows past 16
vectors a lane up to 2,048 vectors (D <= 16,384 in bf16, <= 8,192 in
float32), which holds a row in the registers of one block, 4 vectors a
thread (at zamba2-7b's ``[4096, 7168]`` in bf16 it must move 117.4 MB,
35.06 us at 3.35 TB/s); else the generic two-pass route.  The register
route sums in the order of the generic route's 16-byte loop, so on
aligned rows the two give the same bits; the wide route folds its warps'
sums in warp order, and the generic route's one-value loop (unaligned
rows, D not a multiple of the vector) sums in another order: each agrees
with the plain version to one bf16 ulp.

:func:`rmsnorm_fused` returns through :class:`RMSNormFunction`, whose
forward runs the kernel of ``csrc/rmsnorm.cu`` and whose backward runs
:func:`rmsnorm_bwd`, the kernels of ``csrc/rmsnorm_bwd.cu`` (``dx`` and
``dgamma``, recomputing ``r``).  The backward has routes of its own
(:func:`bwd_route`): a register route with a warp per row where D is a
multiple of 16 bytes' worth of values, at most 8 such vectors per lane
(D <= 2,048 in bf16, D <= 1,024 in float32), and x, gamma and dy are
16-byte aligned; a wide route for such rows up to 2,048 vectors, where a
block walks a chunk of rows a row at a time with 2 or 4 vectors a thread
and the next row's loads in flight (it must move 88.1 and 176.2 MB at
zamba2-7b's ``[4096, 3584]`` and ``[4096, 7168]``, 26.30 and 52.59 us);
else a generic route with a block per chunk of rows.  :func:`bwd_blocks`
sizes the grid, and with it the ``[blocks, D]`` float32 scratch of
dgamma partials (7.3 MB at ``[4096, 7168]``, written once and read once).
Each route gives the same bits from run to run.  Each wrapper runs its
plain version only for tensors on the CPU (which only the tests pass);
for CUDA tensors it launches its kernel on the current stream or raises,
and any other device raises.  No path on a CUDA tensor reaches a plain version.
The wrappers count their launches in ``rmsnorm_fused.launches`` and
``rmsnorm_bwd.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._route import launches_kernel, observed
from repro_torch.kernels.rmsnorm.build import LIB

DTYPES = (torch.float32, torch.bfloat16)
#: the widest row the backward kernel takes (its block's partial dgamma
#: lives in shared memory, 4 bytes a column)
MAX_BWD_D = 56000
#: blocks of the backward's row kernel per SM: the register route's
#: 256-thread blocks (8 warps, a warp a row at a time), the wide route's
#: (up to 16 warps, a block a row at a time, the next row's loads in
#: flight), the generic route's (a block a row at a time)
BWD_BLOCKS_PER_SM = {"register": 2, "wide": 2, "generic": 4}
#: the routes' names by the libraries' route codes
ROUTES = ("generic", "register", "wide")


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


@observed
def rmsnorm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5) -> tuple:
    """``(dx, dgamma)`` of :func:`rmsnorm_fused` at ``x``, ``gamma`` for
    the output gradient ``dy`` (``x``'s shape and dtype, contiguous):
    the kernels of ``csrc/rmsnorm_bwd.cu`` on the card (one launch of the
    row kernel of the route :func:`bwd_route` names and one of the dgamma
    reduction, counted once), the plain version on the CPU."""
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
    blocks = bwd_blocks(bwd_route(x, gamma, dy)[0], rows, sms)
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


def bwd_blocks(kind: str, rows: int, sms: int) -> int:
    """Blocks of the backward's row kernel on route ``kind`` for ``rows``
    rows on ``sms`` SMs, each block walking a contiguous chunk of rows
    and writing one row of the ``[blocks, D]`` float32 scratch: at most
    ``BWD_BLOCKS_PER_SM[kind] * sms`` and at most ``rows``.  The vector
    routes take as few blocks as leave each the same number of rows
    (but the last): on the register route every one of a block's 8
    warps; on the wide route the block itself (256 at 4,096 rows on 132
    SMs, 16 rows each)."""
    cap = BWD_BLOCKS_PER_SM[kind] * sms
    if kind == "register":   # 8 warps a block, each the same number of rows
        per_warp = -(-rows // (8 * cap))
        return -(-rows // (8 * per_warp))
    if kind == "wide":
        return -(-rows // -(-rows // cap))
    return min(rows, cap)


def route(x: torch.Tensor, gamma: torch.Tensor) -> tuple:
    """The route :func:`rmsnorm_fused` takes on the card for these
    CUDA tensors, launching nothing: ``("register", kV, warps)`` with kV
    16-byte vectors per lane and ``warps`` rows per block, ``("wide",
    4, 1)`` (4 vectors a thread, a block a row), or ``("generic", 0,
    warps)``.  Assumes an output from PyTorch's allocator (16-byte
    aligned), as the wrapper makes."""
    d = x.shape[-1]
    code = LIB.load().rmsnorm_route(
        x.data_ptr(), gamma.data_ptr(), None, x.numel() // d, d,
        int(x.dtype == torch.bfloat16))
    kind, rest = divmod(code, 65536)
    return (ROUTES[kind],) + divmod(rest, 256)


def bwd_route(x: torch.Tensor, gamma: torch.Tensor,
              dy: torch.Tensor) -> tuple:
    """The route :func:`rmsnorm_bwd` takes on the card for these CUDA
    tensors, launching nothing: ``("register", kV)`` with kV 16-byte
    vectors per lane, ``("wide", kV)`` with kV (2 or 4) a thread, or
    ``("generic", 0)``.  Assumes a dx from PyTorch's allocator (16-byte
    aligned), as the wrapper makes."""
    d = x.shape[-1]
    kind, kv = divmod(LIB.load().rmsnorm_bwd_route(
        x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), None, d,
        int(x.dtype == torch.bfloat16)), 256)
    return (ROUTES[kind], kv)

"""Mamba2 SSD scan: the within-chunk CUDA wrapper, its plain PyTorch
version, and the full chunked scan built on it.

Counterpart of ``repro/kernels/ssd_scan``.  :func:`ssd_inner` computes,
per (batch, chunk, head) cell, the quadratic within-chunk term and the
chunk-final state of the SSD decomposition (arXiv:2405.21060); it runs
the plain version only for tensors on the CPU (which only the tests
pass), launches the kernel of ``csrc/ssd_scan.cu`` for CUDA tensors or
raises, and counts its launches in ``ssd_inner.launches``.
:func:`ssd_scan_op` adds the chunk reshape, the cumulative decay, the
cross-chunk state recurrence (a loop over chunks) and the off-diagonal
term as torch ops: the same contract as ``models.mamba2.ssd_chunked``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ssd_scan.build import LIB

#: the kernel's tile limits (``csrc/ssd_scan.cu``)
MAX_Q, MAX_N, MAX_P = 128, 128, 64


def ssd_inner_plain(xdt, b_mat, c_mat, dacum):
    """The reference ``ssd_inner_ref`` (float32 math)."""
    xdt, b_mat, c_mat, dacum = (t.float() for t in (xdt, b_mat, c_mat,
                                                    dacum))
    q = xdt.shape[-2]
    diff = dacum[..., :, None] - dacum[..., None, :]      # [B,Nc,H,i,j]
    causal = torch.ones(q, q, dtype=torch.bool, device=xdt.device).tril()
    decay = torch.where(causal, torch.exp(diff), 0.0)
    cb = torch.einsum("bchin,bchjn->bchij", c_mat, b_mat)
    y = torch.einsum("bchij,bchjp->bchip", cb * decay, xdt)
    decay_last = torch.exp(dacum[..., -1:] - dacum)        # [B,Nc,H,Q]
    states = torch.einsum("bchqn,bchqp->bchnp",
                          b_mat * decay_last[..., None], xdt)
    return y, states


def ssd_inner(xdt: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
              dacum: torch.Tensor):
    """xdt ``[B,Nc,H,Q,P]``; b/c ``[B,Nc,H,Q,N]``; dacum ``[B,Nc,H,Q]``,
    all float32 and contiguous.  Returns ``(y_diag [B,Nc,H,Q,P], states
    [B,Nc,H,N,P])``, float32."""
    if xdt.dim() != 5:
        raise ValueError(f"ssd_inner: xdt must be [B,Nc,H,Q,P], got "
                         f"{tuple(xdt.shape)}")
    lead, (q, p) = xdt.shape[:3], xdt.shape[3:]
    n = b_mat.shape[-1]
    want = {"b_mat": (b_mat, (*lead, q, n)), "c_mat": (c_mat, (*lead, q, n)),
            "dacum": (dacum, (*lead, q)), "xdt": (xdt, (*lead, q, p))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"ssd_inner: {name} {tuple(t.shape)}, want "
                             f"{tuple(shape)}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"ssd_inner: {name} must be contiguous "
                             f"float32, got {t.dtype}")
        if t.device != xdt.device:
            raise ValueError(f"ssd_inner: {name} on {t.device}, xdt on "
                             f"{xdt.device}")
    if xdt.device.type == "cpu":
        return ssd_inner_plain(xdt, b_mat, c_mat, dacum)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_inner: unsupported device {xdt.device}")
    if not (1 <= q <= MAX_Q and 1 <= n <= MAX_N and 1 <= p <= MAX_P):
        raise ValueError(f"ssd_inner: Q={q}, N={n}, P={p}; the kernel "
                         f"takes Q <= {MAX_Q}, N <= {MAX_N}, P <= {MAX_P}")
    cells = lead.numel()
    y = torch.empty_like(xdt)
    states = torch.empty((*lead, n, p), dtype=torch.float32,
                         device=xdt.device)
    if cells == 0:
        return y, states
    err = LIB.load().ssd_inner(
        xdt.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(), dacum.data_ptr(),
        y.data_ptr(), states.data_ptr(), cells, q, n, p,
        torch.cuda.current_stream(xdt.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_inner: CUDA error {err}")
    ssd_inner.launches += 1
    return y, states


ssd_inner.launches = 0


def chunk_len(seq: int, chunk: int) -> int:
    """The largest divisor of ``seq`` that is at most ``chunk``."""
    q = min(chunk, seq)
    while seq % q:
        q -= 1
    return q


def chunk_inputs(x, dt, a_log, b_mat, c_mat, chunk: int):
    """The within-chunk block's inputs for a scan of ``x``: ``(xdt
    [B,Nc,H,Q,P], b [B,Nc,H,Q,N], c [B,Nc,H,Q,N], dacum [B,Nc,H,Q])``,
    float32 and contiguous, with Q :func:`chunk_len`."""
    bsz, seq, heads, p = x.shape
    n = b_mat.shape[-1]
    q = chunk_len(seq, chunk)
    nc = seq // q
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    xb = x.reshape(bsz, nc, q, heads, p).to(f32)
    dtb = dt.reshape(bsz, nc, q, heads).to(f32)
    xdt = (xb * dtb[..., None]).transpose(2, 3).contiguous()
    dacum = torch.cumsum(dtb * a, dim=2).transpose(2, 3).contiguous()
    b_t = b_mat.reshape(bsz, nc, q, heads, n).to(f32).transpose(2, 3) \
        .contiguous()
    c_t = c_mat.reshape(bsz, nc, q, heads, n).to(f32).transpose(2, 3) \
        .contiguous()
    return xdt, b_t, c_t, dacum


def ssd_scan_op(x, dt, a_log, b_mat, c_mat, chunk: int, *,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan on the within-chunk kernel.

    x ``[B,S,H,P]`` (dt folded here); dt ``[B,S,H]`` (positive, post-
    softplus); a_log ``[H]`` (A = -exp(a_log)); b/c ``[B,S,H,N]``;
    init_state ``[B,H,N,P]`` or None.  Returns ``(y [B,S,H,P]`` in x's
    dtype, ``final_state [B,H,N,P]`` float32).
    """
    bsz, seq, heads, p = x.shape
    n = b_mat.shape[-1]
    xdt, b_t, c_t, dacum = chunk_inputs(x, dt, a_log, b_mat, c_mat, chunk)
    nc = xdt.shape[1]

    y_diag, states = ssd_inner(xdt, b_t, c_t, dacum)

    # cross-chunk recurrence + off-diagonal term (cheap, outside the kernel)
    chunk_decay = torch.exp(dacum[..., -1])                  # [B,Nc,H]
    s = (init_state.to(torch.float32) if init_state is not None
         else torch.zeros(bsz, heads, n, p, dtype=torch.float32,
                          device=x.device))
    entering = []
    for ci in range(nc):
        entering.append(s)
        s = chunk_decay[:, ci, :, None, None] * s + states[:, ci]
    entering = torch.stack(entering, 1)                      # [B,Nc,H,N,P]
    y_off = torch.matmul(c_t * torch.exp(dacum)[..., None], entering)
    y = (y_diag + y_off).transpose(2, 3).reshape(bsz, seq, heads, p)
    return y.to(x.dtype), s

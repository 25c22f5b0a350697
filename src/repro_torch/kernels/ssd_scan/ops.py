"""Mamba2 SSD scan: the within-chunk CUDA wrapper, its plain PyTorch
version, and the full chunked scan built on it.

Counterpart of ``repro/kernels/ssd_scan``.  :func:`ssd_inner` computes,
per (batch, chunk, head) cell, the quadratic within-chunk term and the
chunk-final state of the SSD decomposition (arXiv:2405.21060).  B and C
come per group: head ``h`` of ``H`` reads group ``h // (H // G)``, the
order of the reference's ``jnp.repeat`` (``repro/models/mamba2.py``);
``G = H`` is the reference kernel's per-head contract.  The dtype picks
the route, with no knob:

* float32 ``xdt``, B and C: on the card the SIMT kernel;
* bfloat16 ``x``, B and C with float32 ``dt``: on the card the
  tensor-core (``wgmma``) kernel, which carries each float32 operand of
  its products, ``M = (C.B^T) * exp(dA_i - dA_j) * dt_j`` and ``W =
  exp(dA_last - dA_j) * dt_j * x_j``, as three bf16 terms (8 significant
  bits each: the float32 value exactly).

Both compute the reference ``ssd_inner_ref``, float32 math on the
inputs with ``x * dt`` never rounded to bf16, as the reference model
computes its SSD on bf16 activations; the plain version, which the CPU
runs, is that function for both dtypes.  Rounding M once, or ``x * dt``,
more than doubles the bf16 model's logit error at 2 layers
(tests/test_torch_mamba2.py::
test_bf16_spread_grows_with_depth_like_reference fails with either).

The block reads ``xdt = x * dt`` (``dt=None``, the TPU kernel's
contract) or ``x`` and ``dt`` ``[B,Nc,H,Q]`` float32, from which it
forms ``x * dt`` in float32 on either route (what :func:`ssd_scan_op`
passes).

Mixed dtypes raise.  :func:`ssd_inner` runs the plain version of its
route only for tensors on the CPU (which only the tests pass), launches
a kernel of ``csrc/ssd_scan.cu`` for CUDA tensors or raises (also
where an input needs a gradient: the kernels have no backward, which
waits for mamba2-130m's training, ROADMAP A.5;
:mod:`repro_torch.kernels._route`), and counts
its launches in ``ssd_inner.launches`` (those of the tensor-core kernel
also in ``ssd_inner.bf16_launches``).  :func:`ssd_scan_op` adds the
chunk reshape, the cumulative decay, the cross-chunk state recurrence
(a loop over chunks) and the off-diagonal term as torch ops: the
contract of ``models.mamba2.ssd_chunked``, with B and C per group.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._route import launches_kernel
from repro_torch.kernels.ssd_scan.build import LIB

#: the kernels' tile limits (``csrc/ssd_scan.cu``)
MAX_Q, MAX_N, MAX_P = 128, 128, 64
DTYPES = (torch.float32, torch.bfloat16)
#: the tensor-core route against its plain version, per output
#: (bf16_limits): y and the states to ATOL_PER_TERM times the sum of the
#: magnitudes of the products they sum (for y, sum_j exp(dA_i - dA_j) dt_j
#: (|C_i|.|B_j|) |x_jp|; for the states, sum_j |B_jn| |W_jp|), twice the
#: worst case of a float32 sum of 128 terms in each of two orders: the
#: sums of C.B^T, which cancel (on the mamba2-130m serve the two sides'
#: C.B^T differ by up to 2**-17 of sum_n |C_in| |B_jn|), and of y and the
#: states
ATOL_PER_TERM = 2.0 ** -14


def _operands(xdt, b_mat, c_mat, dacum, dt=None, magnitudes: bool = False):
    """The plain version's operands, float32, heads split as ``[B, Nc,
    G, H/G, ...]`` with B and C broadcast over the heads of a group:
    ``(m [..,Q,Q], x [..,Q,P], b [B,Nc,G,1,Q,N], w [..,Q,P])`` with y =
    m x and states = b^T w; dt, if given, scales m's columns and w's
    rows.  With ``magnitudes``, ``m`` is ``exp(dA_i - dA_j) (|C_i|.|B_j|)
    dt_j`` (j <= i) and the others are absolute values."""
    bsz, nc, heads, q, p = xdt.shape
    groups = b_mat.shape[2]
    split = (bsz, nc, groups, heads // groups)
    x = xdt.float().reshape(*split, q, p)
    bm = b_mat.float()[:, :, :, None]
    cm = c_mat.float()[:, :, :, None]
    if magnitudes:
        x, bm, cm = x.abs(), bm.abs(), cm.abs()
    da = dacum.float().reshape(*split, q)
    causal = torch.ones(q, q, dtype=torch.bool, device=xdt.device).tril()
    decay = torch.where(causal, torch.exp(da[..., :, None] - da[..., None, :]),
                        0.0)
    m = torch.matmul(cm, bm.transpose(-1, -2)) * decay     # C.B^T per group
    w_scale = torch.exp(da[..., -1:] - da)
    if dt is not None:
        dts = dt.float().reshape(*split, q)
        m, w_scale = m * dts[..., None, :], w_scale * dts
    return m, x, bm, w_scale[..., None] * x


def _merge_heads(t):
    return t.reshape(t.shape[0], t.shape[1], -1, *t.shape[-2:])


def ssd_inner_plain(xdt, b_mat, c_mat, dacum, dt=None):
    """The plain version of both routes: the reference ``ssd_inner_ref``
    (float32 math), with ``x * dt`` formed in float32 where dt is
    given."""
    m, x, bm, w = _operands(xdt, b_mat, c_mat, dacum, dt)
    return (_merge_heads(torch.matmul(m, x)),
            _merge_heads(torch.matmul(bm.transpose(-1, -2), w)))


def bf16_limits(xdt, b_mat, c_mat, dacum, dt=None):
    """Per output, how far the tensor-core kernel may be from the plain
    version: ``ATOL_PER_TERM * sum_j exp(dA_i - dA_j) dt_j (|C_i|.|B_j|)
    |x_jp|`` for y and ``ATOL_PER_TERM * sum_j |B_jn| |W_jp|`` for the
    states (xdt in place of dt_j x_j where dt is None).  Returns float32
    ``(limit_y, limit_states)``."""
    m, x, bm, w = _operands(xdt, b_mat, c_mat, dacum, dt, magnitudes=True)
    return (ATOL_PER_TERM * _merge_heads(torch.matmul(m, x)),
            ATOL_PER_TERM * _merge_heads(torch.matmul(bm.transpose(-1, -2),
                                                      w)))


def ssd_inner(xdt: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
              dacum: torch.Tensor, dt: Optional[torch.Tensor] = None):
    """xdt ``[B,Nc,H,Q,P]`` (x where dt is given); b/c ``[B,Nc,G,Q,N]``
    with G dividing H; dacum and dt ``[B,Nc,H,Q]`` float32; xdt, b and c
    all float32 or all bfloat16; all contiguous, on one device.  Returns
    ``(y_diag [B,Nc,H,Q,P], states [B,Nc,H,N,P])``, float32."""
    if xdt.dim() != 5 or b_mat.dim() != 5:
        raise ValueError(f"ssd_inner: want xdt [B,Nc,H,Q,P] and b, c "
                         f"[B,Nc,G,Q,N], got {tuple(xdt.shape)}, "
                         f"{tuple(b_mat.shape)}")
    bsz, nc, heads, q, p = xdt.shape
    groups, n = b_mat.shape[2], b_mat.shape[-1]
    if groups == 0 or heads % groups:
        raise ValueError(f"ssd_inner: {heads} heads are not a multiple of "
                         f"{groups} groups")
    want = {"b_mat": (b_mat, (bsz, nc, groups, q, n)),
            "c_mat": (c_mat, (bsz, nc, groups, q, n)),
            "dacum": (dacum, (bsz, nc, heads, q))}
    if dt is not None:
        want["dt"] = (dt, (bsz, nc, heads, q))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_inner: {name} {tuple(t.shape)}, want "
                             f"{shape}")
    if xdt.dtype not in DTYPES or b_mat.dtype != xdt.dtype or \
            c_mat.dtype != xdt.dtype or dacum.dtype != torch.float32 or \
            (dt is not None and dt.dtype != torch.float32):
        raise ValueError(f"ssd_inner: want xdt, b, c all float32 or all "
                         f"bfloat16 and dacum, dt float32, got {xdt.dtype}, "
                         f"{b_mat.dtype}, {c_mat.dtype}, {dacum.dtype}, "
                         f"{None if dt is None else dt.dtype}")
    tensors = {"xdt": xdt, "b_mat": b_mat, "c_mat": c_mat, "dacum": dacum}
    if dt is not None:
        tensors["dt"] = dt
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"ssd_inner: {name} must be contiguous")
        if t.device != xdt.device:
            raise ValueError(f"ssd_inner: {name} on {t.device}, xdt on "
                             f"{xdt.device}")
    if not launches_kernel("ssd_inner", xdt, b_mat, c_mat, dacum, dt):
        return ssd_inner_plain(xdt, b_mat, c_mat, dacum, dt)
    if not (1 <= q <= MAX_Q and 1 <= n <= MAX_N and 1 <= p <= MAX_P):
        raise ValueError(f"ssd_inner: Q={q}, N={n}, P={p}; the kernel "
                         f"takes Q <= {MAX_Q}, N <= {MAX_N}, P <= {MAX_P}")
    bf16 = xdt.dtype == torch.bfloat16
    y = torch.empty(xdt.shape, dtype=torch.float32, device=xdt.device)
    states = torch.empty((bsz, nc, heads, n, p), dtype=torch.float32,
                         device=xdt.device)
    if y.numel() == 0:
        return y, states
    err = LIB.load().ssd_inner(
        xdt.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(), dacum.data_ptr(),
        None if dt is None else dt.data_ptr(), y.data_ptr(),
        states.data_ptr(), bsz * nc, heads, groups, q, n, p,
        int(bf16), torch.cuda.current_stream(xdt.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_inner: CUDA error {err}" + (
            " (the bf16 kernel's build has another register count than its "
            "setmaxnreg counts assume)" if err == 200 else ""))
    ssd_inner.launches += 1
    ssd_inner.bf16_launches += bf16
    return y, states


ssd_inner.launches = 0
ssd_inner.bf16_launches = 0


def chunk_len(seq: int, chunk: int) -> int:
    """The largest divisor of ``seq`` that is at most ``chunk``."""
    q = min(chunk, seq)
    while seq % q:
        q -= 1
    return q


def chunk_inputs(x, dt, a_log, b_mat, c_mat, chunk: int):
    """The within-chunk block's inputs for a scan of ``x``: ``(x
    [B,Nc,H,Q,P], b [B,Nc,G,Q,N], c [B,Nc,G,Q,N], dacum [B,Nc,H,Q], dt
    [B,Nc,H,Q])``, contiguous, with Q :func:`chunk_len`; the block forms
    ``x * dt`` in float32.  x, B and C stay bf16 where all three are (the
    tensor-core route), else all are float32; dacum and dt are
    float32."""
    bsz, seq, heads, p = x.shape
    groups, n = b_mat.shape[2:]
    if groups == 0 or heads % groups:
        raise ValueError(f"chunk_inputs: {heads} heads are not a multiple "
                         f"of {groups} groups")
    q = chunk_len(seq, chunk)
    nc = seq // q
    f32 = torch.float32
    dtype = x.dtype if x.dtype == b_mat.dtype == c_mat.dtype == \
        torch.bfloat16 else f32
    dtb = dt.reshape(bsz, nc, q, heads).to(f32)
    dacum = torch.cumsum(dtb * -torch.exp(a_log.to(f32)), dim=2)

    def per_chunk(t, rows):
        return t.reshape(bsz, nc, q, rows, -1).to(dtype).transpose(2, 3) \
            .contiguous()

    return (per_chunk(x, heads), per_chunk(b_mat, groups),
            per_chunk(c_mat, groups), dacum.transpose(2, 3).contiguous(),
            dtb.transpose(2, 3).contiguous())


def ssd_scan_op(x, dt, a_log, b_mat, c_mat, chunk: int, *,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan on the within-chunk kernel.

    x ``[B,S,H,P]`` (dt folded here); dt ``[B,S,H]`` (positive, post-
    softplus); a_log ``[H]`` (A = -exp(a_log)); b/c ``[B,S,G,N]`` with
    G dividing H (head h reads group h // (H/G)); init_state
    ``[B,H,N,P]`` or None.  Returns ``(y [B,S,H,P]`` in x's dtype,
    ``final_state [B,H,N,P]`` float32).
    """
    bsz, seq, heads, p = x.shape
    groups, n = b_mat.shape[2:]
    x_t, b_t, c_t, dacum, dt_t = chunk_inputs(x, dt, a_log, b_mat, c_mat,
                                              chunk)
    nc, q = x_t.shape[1], x_t.shape[3]

    y_diag, states = ssd_inner(x_t, b_t, c_t, dacum, dt_t)

    # cross-chunk recurrence + off-diagonal term (cheap, outside the kernel)
    chunk_decay = torch.exp(dacum[..., -1])                  # [B,Nc,H]
    s = (init_state.to(torch.float32) if init_state is not None
         else torch.zeros(bsz, heads, n, p, dtype=torch.float32,
                          device=x.device))
    entering = []
    for ci in range(nc):
        entering.append(s)
        s = chunk_decay[:, ci, :, None, None] * s + states[:, ci]
    # C_i . entering per group, the group's heads side by side as columns:
    # [B,Nc,G,Q,N] @ [B,Nc,G,N,(H/G) P], so C is never copied per head
    rep = heads // groups
    entering = torch.stack(entering, 1).reshape(bsz, nc, groups, rep, n, p) \
        .permute(0, 1, 2, 4, 3, 5).reshape(bsz, nc, groups, n, rep * p)
    y_off = torch.matmul(c_t.float(), entering).reshape(
        bsz, nc, groups, q, rep, p).permute(0, 1, 3, 2, 4, 5) \
        .reshape(bsz, nc, q, heads, p)                       # [B,Nc,Q,H,P]
    y = y_diag.transpose(2, 3) + \
        y_off * torch.exp(dacum).transpose(2, 3)[..., None]
    return y.reshape(bsz, seq, heads, p).to(x.dtype), s

"""Mamba2 SSD scan: the within-chunk CUDA wrappers (forward and
backward), their plain PyTorch versions, the autograd Function that
joins them, and the full chunked scan built on them.

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

Mixed dtypes raise.  :func:`ssd_inner` returns through
:class:`SSDInnerFunction`: its forward runs the forward kernel with grad
mode off and saves the inputs, its backward runs :func:`ssd_inner_bwd`,
the kernels of ``csrc/ssd_scan_bwd.cu``, whose route :func:`bwd_plan`
picks from the dtype and the shapes (float32 math on either route; bf16
through the tensor cores, every float32 operand as two bf16 terms).
Each wrapper runs its plain version only for tensors on the CPU (which
only the tests pass), launches its kernel for CUDA tensors or raises
(:mod:`repro_torch.kernels._route`), and counts its launches in
``ssd_inner.launches`` and ``ssd_inner_bwd.launches`` (those of the
tensor-core kernels also in ``ssd_inner.bf16_launches`` and
``ssd_inner_bwd.bf16_launches``).
:func:`ssd_scan_op` adds the chunk reshape, the cumulative decay, the
cross-chunk state recurrence (a loop over chunks) and the off-diagonal
term as torch ops: the contract of ``models.mamba2.ssd_chunked``, with
B and C per group.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._route import launches_kernel, observed
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


def _check(name: str, xdt, b_mat, c_mat, dacum, dt, gy=None,
           gstates=None) -> None:
    """The contract of :func:`ssd_inner`, and of the output gradients
    ``gy`` and ``gstates`` where given (:func:`ssd_inner_bwd`)."""
    if xdt.dim() != 5 or b_mat.dim() != 5:
        raise ValueError(f"{name}: want xdt [B,Nc,H,Q,P] and b, c "
                         f"[B,Nc,G,Q,N], got {tuple(xdt.shape)}, "
                         f"{tuple(b_mat.shape)}")
    bsz, nc, heads, q, p = xdt.shape
    groups, n = b_mat.shape[2], b_mat.shape[-1]
    if groups == 0 or heads % groups:
        raise ValueError(f"{name}: {heads} heads are not a multiple of "
                         f"{groups} groups")
    given = {k: t for k, t in (("xdt", xdt), ("b_mat", b_mat),
                               ("c_mat", c_mat), ("dacum", dacum),
                               ("dt", dt), ("gy", gy), ("gstates", gstates))
             if t is not None}
    want = {"xdt": (bsz, nc, heads, q, p), "b_mat": (bsz, nc, groups, q, n),
            "c_mat": (bsz, nc, groups, q, n), "dacum": (bsz, nc, heads, q),
            "dt": (bsz, nc, heads, q), "gy": (bsz, nc, heads, q, p),
            "gstates": (bsz, nc, heads, n, p)}
    for key, t in given.items():
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} {tuple(t.shape)}, want "
                             f"{want[key]}")
    if xdt.dtype not in DTYPES or b_mat.dtype != xdt.dtype or \
            c_mat.dtype != xdt.dtype or any(
                t.dtype != torch.float32 for k, t in given.items()
                if k not in ("xdt", "b_mat", "c_mat")):
        raise ValueError(f"{name}: want xdt, b, c all float32 or all "
                         f"bfloat16 and the rest float32, got " + ", ".join(
                             f"{k} {t.dtype}" for k, t in given.items()))
    for key, t in given.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.device != xdt.device:
            raise ValueError(f"{name}: {key} on {t.device}, xdt on "
                             f"{xdt.device}")


def _tile_limits(name: str, q: int, n: int, p: int) -> None:
    if not (1 <= q <= MAX_Q and 1 <= n <= MAX_N and 1 <= p <= MAX_P):
        raise ValueError(f"{name}: Q={q}, N={n}, P={p}; the kernel "
                         f"takes Q <= {MAX_Q}, N <= {MAX_N}, P <= {MAX_P}")


def _forward(xdt, b_mat, c_mat, dacum, dt):
    """The forward kernel on the card, the plain version on the CPU."""
    if not launches_kernel("ssd_inner", xdt, b_mat, c_mat, dacum, dt):
        return ssd_inner_plain(xdt, b_mat, c_mat, dacum, dt)
    bsz, nc, heads, q, p = xdt.shape
    groups, n = b_mat.shape[2], b_mat.shape[-1]
    _tile_limits("ssd_inner", q, n, p)
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


class SSDInnerFunction(torch.autograd.Function):
    """B3 with its gradient: the forward kernel forward and the backward
    kernels backward on the card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, xdt, b_mat, c_mat, dacum, dt):
        ctx.save_for_backward(xdt, b_mat, c_mat, dacum, dt)
        return _forward(xdt, b_mat, c_mat, dacum, dt)

    @staticmethod
    def backward(ctx, gy, gstates):
        xdt, b_mat, c_mat, dacum, dt = ctx.saved_tensors
        return ssd_inner_bwd(xdt, b_mat, c_mat, dacum, gy.contiguous(),
                             gstates.contiguous(), dt)


def ssd_inner(xdt: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
              dacum: torch.Tensor, dt: Optional[torch.Tensor] = None):
    """xdt ``[B,Nc,H,Q,P]`` (x where dt is given); b/c ``[B,Nc,G,Q,N]``
    with G dividing H; dacum and dt ``[B,Nc,H,Q]`` float32; xdt, b and c
    all float32 or all bfloat16; all contiguous, on one device.  Returns
    ``(y_diag [B,Nc,H,Q,P], states [B,Nc,H,N,P])``, float32,
    differentiable in every input through :class:`SSDInnerFunction`."""
    _check("ssd_inner", xdt, b_mat, c_mat, dacum, dt)
    return SSDInnerFunction.apply(xdt, b_mat, c_mat, dacum, dt)


ssd_inner.launches = 0
ssd_inner.bf16_launches = 0


def ssd_inner_bwd_plain(xdt, b_mat, c_mat, dacum, gy, gstates, dt=None):
    """The gradient of :func:`ssd_inner_plain` by the explicit formulas,
    in float32.  Per cell, with u = xdt (or x * dt), L_ij = exp(dA_i -
    dA_j) [j <= i], M = (C.B^T) L, e_j = exp(dA_last - dA_j) and the
    output gradients gy (of y) and gS (of the states): gu = M^T gy + e
    (B gS); gM = gy u^T on j <= i; per group, G = the sum over its heads
    of gM L, gC = G B and gB = G^T C + the sum over its heads of e (u
    gS^T); with R = gM M, gdA_i = sum_j R_ij - sum_j R_ji, less r_j = e_j
    sum_n B_jn (u gS^T)_jn at j, plus sum_j r_j at the last row; where
    dt is given gx = gu dt and gdt = sum_p gu x.  Returns ``(gxdt, gb,
    gc, gdacum, gdt)`` in the inputs' dtypes (``gdt`` None without
    dt)."""
    bsz, nc, heads, q, p = xdt.shape
    groups, n = b_mat.shape[2], b_mat.shape[-1]
    split = (bsz, nc, groups, heads // groups)
    x = xdt.float().reshape(*split, q, p)
    u = x if dt is None else x * dt.float().reshape(*split, q, 1)
    bm = b_mat.float()[:, :, :, None]
    cm = c_mat.float()[:, :, :, None]
    da = dacum.float().reshape(*split, q)
    gy_ = gy.float().reshape(*split, q, p)
    gs = gstates.float().reshape(*split, n, p)
    causal = torch.ones(q, q, dtype=torch.bool, device=xdt.device).tril()
    decay = torch.where(causal, torch.exp(da[..., :, None] - da[..., None, :]),
                        0.0)
    m = torch.matmul(cm, bm.transpose(-1, -2)) * decay
    e = torch.exp(da[..., -1:] - da)
    gu = torch.matmul(m.transpose(-1, -2), gy_) + \
        e[..., None] * torch.matmul(bm, gs)
    gm = torch.where(causal, torch.matmul(gy_, u.transpose(-1, -2)), 0.0)
    ghat = (gm * decay).sum(3)                               # per group
    w = torch.matmul(u, gs.transpose(-1, -2))                # u gS^T
    gc = torch.matmul(ghat, b_mat.float())
    gb = torch.matmul(ghat.transpose(-1, -2), c_mat.float()) + \
        (e[..., None] * w).sum(3)
    r_mat = gm * m
    r = e * (bm * w).sum(-1)
    last = torch.zeros(q, device=xdt.device)
    last[-1] = 1.0
    ga = r_mat.sum(-1) - r_mat.sum(-2) - r + last * r.sum(-1, keepdim=True)
    gdt = None
    if dt is not None:
        gdt = (gu * x).sum(-1).reshape(dt.shape)
        gu = gu * dt.float().reshape(*split, q, 1)
    return (_merge_heads(gu).to(xdt.dtype), gb.to(b_mat.dtype),
            gc.to(c_mat.dtype), ga.reshape(dacum.shape), gdt)


def bwd_slices(bc: int, heads: int, groups: int, sms: int) -> int:
    """Head slices per group of the backward's tensor-core route: the
    most (a divisor of H / G) that keep its ``bc * groups * slices``
    blocks within one wave of ``sms`` multiprocessors, 1 where even one
    a group exceeds it.  4 at the mamba2-130m and zamba2-7b train steps
    (``bc = 8 x 4``, G = 1) on 132 SMs."""
    rep = heads // groups
    for slices in range(rep, 0, -1):
        if rep % slices == 0 and bc * groups * slices <= sms:
            return slices
    return 1


def bwd_plan(xdt, b_mat, c_mat, gy, gstates, sms: Optional[int] = None):
    """``(route, slices, scratch_floats)`` of :func:`ssd_inner_bwd` on the
    card.  Route ``"wgmma"`` (the tensor cores: ``ssd_bwd_wg`` and
    ``ssd_bwd_gbc``) for bf16 inputs with N and P multiples of 8 and x,
    B, C, gy and gS 16-byte aligned, which covers every shape a model
    trains (mamba2-130m's and zamba2-7b's and their smoke configs');
    ``"simt"`` (``ssd_bwd_head``, ``ssd_bwd_sum``, ``ssd_bwd_group``) for
    float32 and for bf16 the tensor cores cannot take (TMA cannot
    describe them).  Scratch, float32: the tensor-core route's per-slice
    buffer ``bc * G * slices * (3 * 64 * 64 + 128 Nb)`` (Nb the build's
    N, 64 or 128: the block's G^T tiles and its part of gB's state
    term, summed over the slices in order by ``ssd_bwd_gbc``), the SIMT
    route's per-head ``bc * H * Q * (Q + N)``.  ``sms``: the card's
    multiprocessors (read from x's device where None)."""
    bsz, nc, heads, q, p = xdt.shape
    groups, n = b_mat.shape[2], b_mat.shape[-1]
    bc = bsz * nc
    if xdt.dtype == torch.bfloat16 and n % 8 == 0 and p % 8 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (xdt, b_mat, c_mat, gy,
                                             gstates)):
        slices = bwd_slices(bc, heads, groups, sms or torch.cuda
                            .get_device_properties(xdt.device)
                            .multi_processor_count)
        nb = 64 if n <= 64 else 128
        return "wgmma", slices, bc * groups * slices * (3 * 64 * 64 + 128 * nb)
    return "simt", 0, bc * heads * q * (q + n)


@observed
def ssd_inner_bwd(xdt, b_mat, c_mat, dacum, gy, gstates, dt=None):
    """``(gxdt, gb, gc, gdacum, gdt)`` of :func:`ssd_inner` at its inputs
    for the float32 output gradients ``gy`` ``[B,Nc,H,Q,P]`` and
    ``gstates`` ``[B,Nc,H,N,P]`` (contiguous): the kernels of
    ``csrc/ssd_scan_bwd.cu`` on the card (one call, counted once; its
    route from :func:`bwd_plan`: bf16 with N and P multiples of 8 and
    aligned operands through the tensor cores, two launches and a
    per-slice scratch of 14.7 MB at mamba2-130m's train step, x
    ``[8,4,24,128,64]`` with N = 128; otherwise the SIMT kernels, three
    launches and a per-head scratch of 100.7 MB there), the plain
    version on the CPU.  At that shape the call is bound by bytes: 81.3
    MB of inputs and outputs, 24.3 us at 3.35 TB/s (its 5.1 GFLOP of
    causal products take 5 us at the bf16 tensor-core rate).  gxdt, gb
    and gc come in the inputs' dtypes, gdacum and gdt (None without dt)
    in float32."""
    _check("ssd_inner_bwd", xdt, b_mat, c_mat, dacum, dt, gy, gstates)
    if not launches_kernel("ssd_inner_bwd", xdt, b_mat, c_mat, dacum, dt, gy,
                           gstates):
        return ssd_inner_bwd_plain(xdt, b_mat, c_mat, dacum, gy, gstates, dt)
    bsz, nc, heads, q, p = xdt.shape
    groups, n = b_mat.shape[2], b_mat.shape[-1]
    _tile_limits("ssd_inner_bwd", q, n, p)
    dev = xdt.device
    gx = torch.empty_like(xdt)
    gb, gc = torch.empty_like(b_mat), torch.empty_like(c_mat)
    ga = torch.empty_like(dacum)
    gdt = None if dt is None else torch.empty_like(dt)
    if gx.numel() == 0:
        return gx, gb, gc, ga, gdt
    route, slices, floats = bwd_plan(xdt, b_mat, c_mat, gy, gstates)
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    err = LIB.load().ssd_inner_bwd(
        xdt.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
        dacum.data_ptr(), None if dt is None else dt.data_ptr(),
        gy.data_ptr(), gstates.data_ptr(), gx.data_ptr(), gb.data_ptr(),
        gc.data_ptr(), ga.data_ptr(),
        None if gdt is None else gdt.data_ptr(), scratch.data_ptr(),
        bsz * nc, heads, groups, q, n, p, int(xdt.dtype == torch.bfloat16),
        slices, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_inner_bwd: CUDA error {err} on the {route} "
                           f"route")
    ssd_inner_bwd.launches += 1
    ssd_inner_bwd.bf16_launches += route == "wgmma"
    return gx, gb, gc, ga, gdt


ssd_inner_bwd.launches = 0
ssd_inner_bwd.bf16_launches = 0


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

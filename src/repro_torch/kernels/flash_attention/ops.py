"""Flash attention: the CUDA wrappers of the forward and the backward,
their plain PyTorch versions, and the autograd Function that joins them.

Counterpart of ``repro/kernels/flash_attention``: causal or non-causal
grouped-query attention, q ``[B,H,Sq,hd]``, k and v ``[B,Hkv,Skv,hd]``
(``H`` a multiple of ``Hkv``; q head ``h`` reads kv head ``h // (H //
Hkv)``), float32 or bfloat16, all of one dtype; the output has q's
shape and dtype.  Scores are ``q.k^T / sqrt(hd)`` in float32, the
causal mask keeps ``kpos <= qpos`` counted from 0 (top-left, as the TPU
kernel's), the softmax is float32, and the output is cast once at the
end.  ``prefix_len`` P turns the causal mask into the prefix-LM mask of
the VLM family (``repro/models/attention.py:115-118``): the first P
positions see each other, ``kpos <= max(qpos, P - 1)``; P = 0 is the
plain causal mask, bit for bit.  Where the dtypes differ:

* float32: ``P`` stays float32 for ``P.V`` (the TPU kernel's function,
  ``attention_ref``);
* bfloat16: the scores are products of the bf16 inputs accumulated in
  float32 and scaled after the product, and the probabilities are
  rounded to bf16 before ``P.V``, which accumulates in float32: what
  the served model computes (``repro/models/attention.py:107,127`` and
  the port's ``gqa_attend``).  The kernel rounds the unnormalised
  ``exp(s - m)`` of each kv tile instead of the normalised
  probabilities, so kernel and plain version differ by where that one
  rounding falls; tests/test_torch_flash_attention.py bounds it.

Unlike the TPU kernel, any ``Sq`` and ``Skv >= 1`` are taken, and any
head dim up to :data:`MAX_HEAD_DIM`.

:func:`flash_attention` returns through :class:`FlashAttentionFunction`,
whose forward runs a kernel of ``csrc/flash_attention.cu`` and whose
backward runs :func:`flash_attention_bwd`, the kernels of
``csrc/flash_attention_bwd.cu`` (every head dim the forward takes,
builds of 64, 128 and 256).  Where a bfloat16 call needs a gradient the
forward kernel also writes each row's logsumexp (:func:`flash_lse_plain`
is its plain version), which the Function saves and hands to the
backward; under ``no_grad`` (every serve) it asks for none, and the
output is the same bits either way.  The backward takes one of two
routes (:func:`bwd_route`): bfloat16 inputs that TMA can describe go to
the tensor-core (``wgmma``) kernels at every head dim from 8 to 256
(a multiple of 8), which read that LSE, round P to bf16 for dV as the
plain version does, carry dS into dQ and dK as two bf16 terms (hi +
lo), and split the G q heads of each kv head into :func:`dkdv_parts`
parts whose float32 partials a second pass sums; float32 inputs (and
bfloat16 ones TMA cannot describe) go to the SIMT kernels, which
recompute the LSE.  Each wrapper runs its plain version only for tensors on the CPU (which only
the tests pass); for CUDA tensors it launches its kernels on the
current stream or raises, and any other device raises.  No path on a
CUDA tensor reaches a plain version.  The forward's dtype picks its
kernel: float32 goes to the SIMT kernel, bfloat16 to the tensor-core
(``wgmma``) one.  The wrappers count their calls that launch in
``flash_attention.launches`` and ``flash_attention_bwd.launches`` (one
count for all the kernels of a backward call).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels._route import launches_kernel, observed
from repro_torch.kernels.flash_attention.build import LIB

DTYPES = (torch.float32, torch.bfloat16)
#: the largest head dim the kernels are built for (float32 builds of 16,
#: 32, 64, 128 and 256, bf16 builds of 64, 128 and 256; a smaller head
#: dim runs in the next larger build)
MAX_HEAD_DIM = 256
#: the largest head dim the backward kernels are built for (builds of 64,
#: 128 and 256 on both routes; a smaller head dim runs in the next larger
#: build): every head dim the forward takes
MAX_BWD_HEAD_DIM = MAX_HEAD_DIM
#: the TPU kernel's mask value
NEG_INF = -1e30
#: rows of the tensor-core backward's kv tiles (its dK/dV items)
BWD_KV_TILE = 64


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          prefix_len: int = 0) -> torch.Tensor:
    """float32: the reference ``attention_ref``, float32 math and one
    cast at the end.  bfloat16: the same, with the probabilities rounded
    to bf16 before a float32 ``P.V``, as the served model rounds them.
    ``prefix_len``: the causal mask keeps ``kpos <= max(qpos, prefix_len
    - 1)``."""
    group = q.shape[1] // k.shape[1]
    sq, skv, hd = q.shape[2], k.shape[2], q.shape[3]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        limit = torch.arange(sq, device=q.device).clamp(min=prefix_len - 1)
        mask = torch.arange(skv, device=q.device)[None, :] <= limit[:, None]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    return torch.matmul(p, vf).to(q.dtype)


def flash_lse_plain(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                    prefix_len: int = 0) -> torch.Tensor:
    """float32 ``[B,H,Sq]``: each row's natural-log logsumexp of its
    scores ``q.k^T / sqrt(hd)`` (float32 math) under the forward's mask,
    the LSE the bfloat16 forward kernel writes for the backward."""
    group = q.shape[1] // k.shape[1]
    sq, skv, hd = q.shape[2], k.shape[2], q.shape[3]
    kf = k.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        limit = torch.arange(sq, device=q.device).clamp(min=prefix_len - 1)
        mask = torch.arange(skv, device=q.device)[None, :] <= limit[:, None]
        s = torch.where(mask, s, NEG_INF)
    return torch.logsumexp(s, dim=-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, *, causal: bool = True,
                              prefix_len: int = 0) -> tuple:
    """``(dq, dk, dv)`` of :func:`flash_attention_plain` by the explicit
    formula, in float32: ``D = rowsum(dO * O)``, ``P = exp(S - LSE)``
    with ``S = q.k^T / sqrt(hd)`` under the forward's mask, ``dV = P^T
    dO`` (bfloat16: P rounded to bf16 first, as the forward rounds it
    before ``P.V``), ``dP = dO V^T``, ``dS = P * (dP - D)``, ``dQ = dS K
    / sqrt(hd)``, ``dK = dS^T Q / sqrt(hd)``; dK and dV summed over the
    q heads of each kv head, each gradient cast once to its input's
    dtype."""
    bsz, heads, sq, hd = q.shape
    kv_heads, skv = k.shape[1], k.shape[2]
    group = heads // kv_heads
    root = math.sqrt(hd)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) / root
    if causal:
        limit = torch.arange(sq, device=q.device).clamp(min=prefix_len - 1)
        mask = torch.arange(skv, device=q.device)[None, :] <= limit[:, None]
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    pv = p.to(torch.bfloat16).float() if q.dtype == torch.bfloat16 else p
    dv = torch.matmul(pv.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) / root
    dk = torch.matmul(ds.transpose(-1, -2), qf) / root

    def per_kv_head(g):
        return g.view(bsz, kv_heads, group, skv, hd).sum(2)

    return (dq.to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))


class FlashAttentionFunction(torch.autograd.Function):
    """B2 with its gradient: the forward kernel forward and the backward
    kernels backward on the card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, prefix_len, want_lse):
        o, lse = _forward(q, k, v, causal, prefix_len, want_lse=want_lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.prefix_len = causal, prefix_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                         causal=ctx.causal,
                                         prefix_len=ctx.prefix_len, lse=lse)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, prefix_len: int = 0) -> torch.Tensor:
    """q ``[B,H,Sq,hd]``; k, v ``[B,Hkv,Skv,hd]``, contiguous, one dtype
    and device.  ``prefix_len`` (``0 <= prefix_len <= Skv``, only with
    ``causal``): the prefix-LM boundary.  Returns a new ``[B,H,Sq,hd]``
    tensor in q's dtype, differentiable in q, k and v at every head dim
    it takes."""
    prefix_len = _check(q, k, v, causal, prefix_len)
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad
                                                 for t in (q, k, v))
    # the bf16 backward reads the forward's LSE; float32's recomputes it
    want_lse = needs_grad and q.dtype == torch.bfloat16
    return FlashAttentionFunction.apply(q, k, v, causal, prefix_len,
                                        want_lse)


def _check(q, k, v, causal: bool, prefix_len: int) -> int:
    """Checks the forward's inputs; returns ``prefix_len`` as an int."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q [B,H,Sq,hd] and k, v "
                         f"[B,Hkv,Skv,hd], got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    bsz, heads, sq, hd = q.shape
    kv_heads, skv = k.shape[1], k.shape[2]
    if k.shape[0] != bsz or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if kv_heads == 0 or heads % kv_heads:
        raise ValueError(f"flash_attention: {heads} heads are not a "
                         f"multiple of {kv_heads} kv heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd}; the kernel is "
                         f"built for 1 to {MAX_HEAD_DIM}")
    if skv == 0:
        raise ValueError("flash_attention: no keys to attend to (Skv = 0)")
    prefix_len = int(prefix_len)
    if prefix_len and not causal:
        raise ValueError(f"flash_attention: a prefix of {prefix_len} is a "
                         f"mode of the causal mask, and causal is False")
    if not 0 <= prefix_len <= skv:
        raise ValueError(f"flash_attention: prefix_len {prefix_len} outside "
                         f"[0, Skv = {skv}]")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: want q, k, v all float32 or all "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    return prefix_len


def _forward(q, k, v, causal: bool, prefix_len: int, *,
             want_lse: bool = False) -> tuple:
    """``(out, lse)``: the forward kernel on the card, the plain version
    on the CPU; ``lse`` float32 ``[B,H,Sq]`` (bfloat16 only) where
    ``want_lse``, else None."""
    bsz, heads, sq, hd = q.shape
    kv_heads, skv = k.shape[1], k.shape[2]
    if want_lse and q.dtype != torch.bfloat16:
        raise ValueError("flash_attention: the forward writes an LSE for "
                         "bfloat16 inputs only")
    if not launches_kernel("flash_attention", q, k, v):
        out = flash_attention_plain(q, k, v, causal=causal,
                                    prefix_len=prefix_len)
        return out, (flash_lse_plain(q, k, causal=causal,
                                     prefix_len=prefix_len)
                     if want_lse else None)
    if q.dtype == torch.float32 and (bsz > 65535 or heads > 65535):
        raise ValueError(f"flash_attention: B = {bsz}, H = {heads}; the "
                         f"float32 kernel's grid takes at most 65535 of each")
    out = torch.empty_like(q)
    lse = (torch.empty((bsz, heads, sq), dtype=torch.float32,
                       device=q.device) if want_lse else None)
    if out.numel() == 0:
        return out, lse
    err = LIB.load().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), bsz, heads, kv_heads, sq,
        skv, hd, int(causal), prefix_len, int(q.dtype == torch.bfloat16),
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention: CUDA error {err}" + (
            " (the bf16 kernel's build has another register count than its "
            "setmaxnreg counts assume)" if err == 200 else ""))
    flash_attention.launches += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        prefix_len: int = 0) -> tuple:
    """``(out, lse)`` of the bfloat16 forward, no gradient: the output of
    :func:`flash_attention` and the LSE its kernel writes for the
    backward (on the CPU the plain versions)."""
    prefix_len = _check(q, k, v, causal, prefix_len)
    return _forward(q, k, v, causal, prefix_len, want_lse=True)


flash_attention.launches = 0


def dkdv_parts(batch: int, kv_heads: int, skv: int, group: int,
               sms: int) -> int:
    """Parts the tensor-core backward splits each kv head's G q heads
    into: the smallest divisor of G that gives the dK/dV kernel at least
    one (batch, kv head, kv tile, part) item per SM, else G.  Each part
    beyond the first costs a float32 partial of dK and dV."""
    tiles = batch * kv_heads * -(-skv // BWD_KV_TILE)
    for parts in range(1, group + 1):
        if group % parts == 0 and tiles * parts >= sms:
            return parts
    return group


def bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, do: torch.Tensor) -> str:
    """The backward's route for these inputs: ``"wgmma"`` for bfloat16
    that TMA can describe (head dim a multiple of 8, every tensor 16-byte
    aligned: the builds of 64, 128 and 256 take head dims up to 64, 65 to
    128 and 129 to 256), else ``"simt"`` (float32, and bfloat16 that TMA
    cannot describe, in builds of the same head dims)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, o, do))
    return ("wgmma" if q.dtype == torch.bfloat16 and q.shape[3] % 8 == 0
            and aligned else "simt")


@observed
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, prefix_len: int = 0,
                        lse: torch.Tensor | None = None) -> tuple:
    """``(dq, dk, dv)`` of :func:`flash_attention` at q, k, v for the
    output ``o`` and its gradient ``do`` (both q's shape and dtype,
    contiguous): the kernels of ``csrc/flash_attention_bwd.cu`` on the
    card (the route :func:`bwd_route` names), the plain version on the
    CPU.  ``lse``: the forward's float32
    ``[B,H,Sq]`` LSE (:func:`flash_attention_fwd`), which the tensor-core
    route reads; where it is None that route runs the forward kernel
    once more to get it.  The SIMT route and the plain version compute
    their own."""
    prefix_len = _check(q, k, v, causal, prefix_len)
    for name, t in (("o", o), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype} on {t.device} "
                             f"does not match q {tuple(q.shape)} {q.dtype} "
                             f"on {q.device}, or is not contiguous")
    if lse is not None and (lse.shape != q.shape[:3]
                            or lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}; want float32 "
                         f"{tuple(q.shape[:3])} on {q.device}, contiguous")
    if not launches_kernel("flash_attention_bwd", q, k, v, o, do):
        return flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         prefix_len=prefix_len)
    bsz, heads, sq, hd = q.shape
    kv_heads, skv = k.shape[1], k.shape[2]
    lib = LIB.load()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    parts, part = 1, None
    if bwd_route(q, k, v, o, do) == "wgmma":
        if lse is None:
            _, lse = _forward(q, k, v, causal, prefix_len, want_lse=True)
        sq_pad = -(-sq // 128) * 128
        scratch = torch.empty((bsz * heads, sq_pad, 2), dtype=torch.float32,
                              device=q.device)
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        parts = dkdv_parts(bsz, kv_heads, skv, heads // kv_heads, sms)
        if parts > 1:
            part = torch.empty((2, parts, bsz * kv_heads, skv, hd),
                               dtype=torch.float32, device=q.device)
    else:
        lse = None
        scratch = torch.empty((2, bsz, heads, sq), dtype=torch.float32,
                              device=q.device)
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if lse is None else lse.data_ptr(), scratch.data_ptr(),
        None if part is None else part.data_ptr(), bsz, heads, kv_heads, sq,
        skv, hd, int(causal), prefix_len, int(q.dtype == torch.bfloat16),
        parts, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd: CUDA error {err}" + (
            " (the tensor-core kernels' build has another register count "
            "than their setmaxnreg counts assume)" if err == 200 else ""))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0

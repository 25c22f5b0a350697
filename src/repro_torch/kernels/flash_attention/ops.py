"""Flash attention: the CUDA wrapper and its plain PyTorch version.

Counterpart of ``repro/kernels/flash_attention``: causal or non-causal
grouped-query attention, q ``[B,H,Sq,hd]``, k and v ``[B,Hkv,Skv,hd]``
(``H`` a multiple of ``Hkv``; q head ``h`` reads kv head ``h // (H //
Hkv)``), float32 or bfloat16, all of one dtype; the output has q's
shape and dtype.  Scores are ``q.k^T / sqrt(hd)`` in float32, the
causal mask keeps ``kpos <= qpos`` counted from 0 (top-left, as the TPU
kernel's), the softmax is float32, and the output is cast once at the
end.  Where the dtypes differ:

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

:func:`flash_attention` runs the plain version only for tensors on the
CPU (which only the tests pass).  For CUDA tensors it launches a kernel
of ``csrc/flash_attention.cu`` on the current stream or raises; any
other device raises, and so does a CUDA call that would need a gradient
(the kernels have no backward yet: :mod:`repro_torch.kernels._route`).
The dtype picks the kernel: float32 goes to the
SIMT kernel, bfloat16 to the tensor-core (``wgmma``) one.  It counts
its launches in ``flash_attention.launches``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels._route import launches_kernel
from repro_torch.kernels.flash_attention.build import LIB

DTYPES = (torch.float32, torch.bfloat16)
#: the largest head dim the kernels are built for (float32 builds of 16,
#: 32, 64 and 128, bf16 builds of 64 and 128; a smaller head dim runs in
#: the next larger build)
MAX_HEAD_DIM = 128
#: the TPU kernel's mask value
NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """float32: the reference ``attention_ref``, float32 math and one
    cast at the end.  bfloat16: the same, with the probabilities rounded
    to bf16 before a float32 ``P.V``, as the served model rounds them."""
    group = q.shape[1] // k.shape[1]
    sq, skv, hd = q.shape[2], k.shape[2], q.shape[3]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        mask = torch.arange(skv, device=q.device)[None, :] <= \
            torch.arange(sq, device=q.device)[:, None]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    return torch.matmul(p, vf).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q ``[B,H,Sq,hd]``; k, v ``[B,Hkv,Skv,hd]``, contiguous, one dtype
    and device.  Returns a new ``[B,H,Sq,hd]`` tensor in q's dtype."""
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
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: want q, k, v all float32 or all "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    if not launches_kernel("flash_attention", q, k, v):
        return flash_attention_plain(q, k, v, causal=causal)
    if q.dtype == torch.float32 and (bsz > 65535 or heads > 65535):
        raise ValueError(f"flash_attention: B = {bsz}, H = {heads}; the "
                         f"float32 kernel's grid takes at most 65535 of each")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = LIB.load().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bsz, heads,
        kv_heads, sq, skv, hd, int(causal), int(q.dtype == torch.bfloat16),
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention: CUDA error {err}" + (
            " (the bf16 kernel's build has another register count than its "
            "setmaxnreg counts assume)" if err == 200 else ""))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

"""Grouped-query attention with RoPE and a KV cache.

Counterpart of ``repro/models/attention.py``.  A layer's compute
weights are a dict (:meth:`repro_torch.models.transformer.DenseLM.
weights`): ``wqkv`` ``[D, (H + 2 Hkv) hd]``, the three input projections
side by side so that one product computes them, ``bqkv`` with the QKV
bias, and ``wo``.  The reference's sharding constraints are here as
:func:`~repro_torch.models.common.constrain` calls, which act on the
dry run's DTensors only: heads over "model" when they divide, else q
over the sequence and k, v replicated; the output back to the
batch-over-data layout.  On DTensors ``wqkv`` is the three projections'
tuple (:func:`~repro_torch.models.common.join`).  The attention core is
the ``attn_core`` scope (:func:`~repro_torch.models.common.scoped`), the
region the flash kernel replaces, as the reference names it.

The reference model groups heads as ``[G, Hkv]``: q head ``g Hkv + j``
attends with kv head ``j``.  The flash kernel (B2) groups them as
``[Hkv, G]``: q head ``h`` reads kv head ``h // G``.  :func:`flash_attend`
reorders the q heads into the kernel's order on the way in and back on
the way out, inside the transposes to and from the kernel's ``[B, H, S,
hd]`` layout.  Those are differentiable copies, so in training B2's
gradient (its backward kernel, through the kernel's autograd Function)
flows back through them into the reference's head order.
:func:`gqa_attend` is the reference's plain attention with positions
and a valid length; decode uses it, and the tests hold the flash path
against it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (ModelConfig, apply_rope, constrain,
                                       dp_spec, is_sharded, mesh_axes,
                                       scoped, split_product)
from repro_torch.sharding.local import (attention_per_rank, pin,
                                        write_positions)

#: the reference's mask value
NEG_INF = -1e30


def qkv_project(w: dict, x: torch.Tensor, cfg: ModelConfig,
                positions, *, rope: bool = True):
    """x ``[B,S,D]`` -> q ``[B,S,H,hd]``, k and v ``[B,S,Hkv,hd]``, RoPE
    applied to q and k at ``positions`` ``[B,S]`` unless ``rope`` is
    False (the enc-dec family's encoder and cross-attention, where
    ``positions`` is not read)."""
    bsz, seq, _ = x.shape
    hd, heads, kv_heads = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q, k, v = split_product(x, w["wqkv"],
                            [heads * hd, kv_heads * hd, kv_heads * hd],
                            w["bqkv"] if cfg.qkv_bias else None)
    q, k, v = _heads_layout(q, k, v, cfg)
    q = q.reshape(bsz, seq, heads, hd)
    k = k.reshape(bsz, seq, kv_heads, hd)
    v = v.reshape(bsz, seq, kv_heads, hd)
    if not rope:
        return q, k, v
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _heads_layout(q, k, v, cfg: ModelConfig):
    """The reference's layouts for q ``[B,S,H hd]``, k and v before their
    heads are split out (:func:`heads_layout`)."""
    return (heads_layout(q, cfg.n_heads, over_positions=True),
            heads_layout(k, cfg.n_kv_heads),
            heads_layout(v, cfg.n_kv_heads))


def heads_layout(t, heads: int, *, over_positions: bool = False):
    """The reference's layout for ``t`` ``[B,S,heads hd]`` before its heads
    are split out: heads over "model" when they divide, else (for q,
    ``over_positions``, with more than one position) the sequence over
    "model", else replicated there; the batch over the data dims.  A
    plain tensor passes as it is."""
    axes = mesh_axes(t)
    if not axes:
        return t
    model, dp = max(axes.get("model", 1), 1), dp_spec(t)
    if heads and heads % model == 0:
        return constrain(t, dp, None, "model")
    if over_positions and t.shape[1] > 1:
        return constrain(t, dp, "model", None)
    return constrain(t, dp, None, None)


def flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, prefix_len: int = 0) -> torch.Tensor:
    """Attention through the flash kernel (B2), with the reference's head
    grouping.  q ``[B,Sq,H,hd]``, k and v ``[B,Skv,Hkv,hd]`` ->
    ``[B,Sq,H,hd]``.  ``causal``: a whole sequence from position 0
    (``Sq == Skv``, the kernel's top-left mask), where ``prefix_len`` P
    lets the first P positions see each other (the VLM's prefix-LM mask);
    otherwise every query sees every key (an encoder, or cross-attention
    with ``Sq != Skv``).  With one kv head (paligemma) the permute below
    is the identity; it stays on the path.  On DTensors the core runs
    per rank (:func:`~repro_torch.sharding.local.attention_per_rank`)."""
    if is_sharded(q):      # k, v from a position-sharded cache: gathered
        return attention_per_rank(_flash_attend, q, k, v, gather_kv=True,
                                  causal=causal, prefix_len=prefix_len)
    return _flash_attend(q, k, v, causal=causal, prefix_len=prefix_len)


def _flash_attend(q, k, v, *, causal: bool, prefix_len: int):
    bsz, seq, heads, hd = q.shape
    kv_heads = k.shape[2]
    group = heads // kv_heads
    # model head g * Hkv + j -> kernel head j * G + g
    qk = q.reshape(bsz, seq, group, kv_heads, hd).permute(0, 3, 2, 1, 4) \
        .contiguous().view(bsz, heads, seq, hd)
    o = scoped("attn_core", flash_attention, qk,
               k.transpose(1, 2).contiguous(),
               v.transpose(1, 2).contiguous(), causal=causal,
               prefix_len=prefix_len)
    return o.view(bsz, kv_heads, group, seq, hd).permute(0, 3, 2, 1, 4) \
        .reshape(bsz, seq, heads, hd)


def gqa_attend(q, k, v, *, causal: bool,
               kv_valid_len=None) -> torch.Tensor:
    """The reference's plain grouped-query attention (its
    ``_attend_dense_inner``, without the q-chunk loop, which changes no
    number, and with positions counted from 0).  q ``[B,Sq,H,hd]``, k
    and v ``[B,Skv,Hkv,hd]``.  Scores in float32 from exact products,
    scaled after the dot; the causal mask keeps ``kpos <= qpos``;
    ``kv_valid_len`` ``[B]`` masks cache slots at or past it.  The
    probabilities are cast to v's dtype before the product with v.  The
    ``attn_core`` scope.  On DTensors the core runs per rank where it is
    local (:func:`~repro_torch.sharding.local.attention_per_rank`), else
    (over a sequence-sharded cache) through DTensor's own rules, with q's
    heads gathered."""
    if is_sharded(q):
        extra = () if kv_valid_len is None else (kv_valid_len,)
        out = attention_per_rank(_gqa_scoped, q, k, v, *extra,
                                 causal=causal)
        if out is not None:
            return out
        q = constrain(q, dp_spec(q), None, None, None)
        return constrain(_gqa_scoped(q, k, v, kv_valid_len, causal=causal),
                         dp_spec(q), None, None, None)
    return _gqa_scoped(q, k, v, kv_valid_len, causal=causal)


def _gqa_scoped(q, k, v, kv_valid_len=None, *, causal: bool):
    return scoped("attn_core", _gqa_attend, q, k, v, causal=causal,
                  kv_valid_len=kv_valid_len)


def _gqa_attend(q, k, v, *, causal: bool, kv_valid_len) -> torch.Tensor:
    bsz, sq, heads, hd = q.shape
    skv, kv_heads = k.shape[1], k.shape[2]
    group = heads // kv_heads
    qg = q.reshape(bsz, sq, group, kv_heads, hd)
    logits = torch.einsum("bqghd,bkhd->bghqk", qg.float(), k.float()) \
        * (1.0 / math.sqrt(hd))
    mask = None
    if causal:                                              # [1,Sq,Skv]
        mask = (torch.arange(skv, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])[None]
    if kv_valid_len is not None:
        lim = torch.arange(skv, device=q.device)[None, :] < \
            kv_valid_len[:, None]
        lim = lim[:, None, :].expand(bsz, sq, skv)
        mask = lim if mask is None else (mask & lim)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bghqk,bkhd->bqghd", probs.to(v.dtype), v)
    return out.reshape(bsz, sq, heads, hd)


def attn_output(w: dict, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The output projection, back in the batch-over-data layout."""
    bsz, seq, heads, hd = o.shape
    o = o.reshape(bsz, seq, heads * hd)
    # on DTensors, o's gradient comes back in o's layout, which the split
    # into heads can follow where they do not divide "model"
    out = (pin(o) if is_sharded(o) else o) @ w["wo"]
    return constrain(out, dp_spec(out), None, None)


# ------------------------------------------------------------------ caching
class KVCache(NamedTuple):
    k: torch.Tensor        # [L, B, Smax, Hkv, hd]
    v: torch.Tensor        # [L, B, Smax, Hkv, hd]
    length: torch.Tensor   # [B] int32, filled prefix length


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               n_layers: int | None = None, device=None) -> KVCache:
    """The reference's stacked cache: leading dim ``n_layers`` (default
    ``cfg.n_layers``)."""
    n_layers = cfg.n_layers if n_layers is None else n_layers
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        length=torch.zeros(batch, dtype=torch.int32, device=device))


def cache_update(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, start: int):
    """Write ``k_new``/``v_new`` ``[B,S,Hkv,hd]`` at position ``start``
    of one layer's preallocated cache ``[B,Smax,Hkv,hd]``, in place (the
    reference returns updated copies); returns the two caches.  A write
    past ``Smax`` raises where the reference clamps its start."""
    seq = k_new.shape[1]
    if not 0 <= start <= cache_k.shape[1] - seq:
        raise ValueError(f"cache_update: {seq} slots at {start} do not fit "
                         f"a cache of {cache_k.shape[1]}")
    if is_sharded(cache_k):          # the dry run's, maybe position-sharded
        write_positions(cache_k, k_new, start)
        write_positions(cache_v, v_new, start)
        return cache_k, cache_v
    cache_k[:, start:start + seq] = k_new
    cache_v[:, start:start + seq] = v_new
    return cache_k, cache_v

"""Decoder-only transformer LM: the dense family (qwen2, llama3,
stablelm, codeqwen) and the MoE family (granite-moe, qwen2-moe).

Counterpart of ``repro/models/transformer.py``.  The reference scans
stacked per-layer parameters; here the layers are an ``nn.ModuleList``
run in a Python loop, with float32 masters under the reference's names
(``blocks.{i}.attn.wq``, ...).  :meth:`DenseLM.weights` casts them to
``cfg.dtype`` once, with the three attention input projections and the
two gated MLP inputs joined side by side, and keeps the copies until
the module moves or is reloaded (:class:`~repro_torch.models.common.
CastCache`) or an optimizer step drops them.  Training
(:func:`lm_train_apply`) casts anew on every call, with gradients, so
the gradient flows through the casts and the joins to the float32
masters; serving keeps the cache and runs without gradients.

The prefill (and the teacher-forced forward) runs its attention through
the flash kernel B2 (:func:`~repro_torch.models.attention.flash_attend`):
there the positions are ``arange(S)`` for every row and no slot is
masked, so the kernel's top-left causal mask is the model's.  The VLM
family (:mod:`repro_torch.models.vlm`) is this LM with
``extra_embeds`` (the image patches, put before the token embeddings)
and ``prefix_len`` (B2's prefix-LM mode over them).  A decode
step attends with one query over a partly filled cache in plain PyTorch
(:func:`~repro_torch.models.attention.gqa_attend`), as the reference
does outside any kernel.  The KV cache is preallocated per layer and
written in place: a decode state is consumed by the step that follows
it.

The MoE family (granite-moe, qwen2-moe) builds a ``moe`` submodule
(:class:`~repro_torch.models.moe.MoE`) in place of ``mlp``.  Its
compute weights keep the router in float32.  ``block_forward`` follows
``cfg.moe_impl``: ``"einsum"`` (:func:`~repro_torch.models.moe.
moe_einsum`), or ``"ep"`` through :func:`~repro_torch.collectives.
moe_ep.moe_ep` on the ``mesh`` the caller gives (``lm_apply``'s
``mesh=``), with this rank's experts.  ``block_decode`` always calls
``moe_einsum``, as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import (CastCache, Family, ModelConfig,
                                       checkpoint_wrap, dense_init,
                                       embed_rows, join, normal, rmsnorm)
from repro_torch.models.mlp import MLP, mlp, mlp_weights, param
from repro_torch.models.moe import MoE, init_moe, moe_einsum, moe_weights


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        shapes = {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv),
                  "wo": (hq, d)}
        if cfg.qkv_bias:
            shapes.update(bq=(hq,), bk=(hkv,), bv=(hkv,))
        for name, shape in shapes.items():
            self.register_parameter(name, param(shape, cfg, device))


class DenseBlock(nn.Module):
    """One layer: ``x + attn(rmsnorm(x, ln1))``, then ``+ mlp(rmsnorm(.,
    ln2))``, or ``+ moe(...)`` in the MoE family."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = param((cfg.d_model,), cfg, device, 1.0)
        self.attn = Attention(cfg, device)
        self.ln2 = param((cfg.d_model,), cfg, device, 1.0)
        if cfg.family == Family.MOE:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device)


class DenseLM(CastCache):
    """Embedding, ``n_layers`` :class:`DenseBlock`, the final norm and,
    unless tied, the LM head; parameters allocated on ``device``.  The
    transformer LM of both the dense and the MoE family."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family not in (Family.DENSE, Family.MOE, Family.VLM):
            raise ValueError(f"{cfg.name}: a {cfg.family.value} config, "
                             f"want the dense or the MoE family, or the VLM")
        self.cfg = cfg
        self.embed = param((cfg.vocab_padded, cfg.d_model), cfg, device)
        self.blocks = nn.ModuleList(DenseBlock(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = param((cfg.d_model,), cfg, device, 1.0)
        if not cfg.tie_embeddings:
            self.lm_head = param((cfg.d_model, cfg.vocab_padded), cfg,
                                  device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "DenseLM":
        """Random weights from ``gen``, laid out as the reference's
        ``init_lm``: embed N(0, 0.02^2), projections N(0, 1/fan_in) (``wo``
        over ``H hd``), zero biases, unit norms.  Each tensor is drawn on
        the host and copied to the module's device as it is drawn."""
        cfg, pd = self.cfg, self.cfg.param_dtype
        self.embed.copy_(normal(gen, self.embed.shape, 0.02, pd))
        for block in self.blocks:
            init_block_(block, gen, cfg)
        self.ln_f.fill_(1.0)
        if not cfg.tie_embeddings:
            self.lm_head.copy_(dense_init(gen, *self.lm_head.shape, pd,
                                          scale=0.02))
        self._cw = None
        return self

    def _cast(self) -> dict:
        cfg, dt = self.cfg, self.cfg.dtype
        embed = self.embed.to(dt)
        head = embed.T if cfg.tie_embeddings else self.lm_head.to(dt)
        return {"embed": embed, "head": head, "ln_f": self.ln_f.to(dt),
                "blocks": [block_weights(b, cfg) for b in self.blocks]}


def init_attn_(a: Attention, gen: torch.Generator, cfg: ModelConfig) -> None:
    """The reference's ``init_attn``: projections N(0, 1/fan_in) (``wo``
    over ``H hd``), zero biases."""
    pd = cfg.param_dtype
    for w in (a.wq, a.wk, a.wv, a.wo):
        w.copy_(dense_init(gen, *w.shape, pd))
    if cfg.qkv_bias:
        for b in (a.bq, a.bk, a.bv):
            b.zero_()


def init_mlp_(m: MLP, gen: torch.Generator, cfg: ModelConfig) -> None:
    """The reference's ``init_mlp``: N(0, 1/fan_in)."""
    pd = cfg.param_dtype
    m.w_in.copy_(dense_init(gen, *m.w_in.shape, pd))
    m.w_out.copy_(dense_init(gen, *m.w_out.shape, pd))
    if cfg.glu:
        m.w_gate.copy_(dense_init(gen, *m.w_gate.shape, pd))


@torch.no_grad()
def init_block_(block: DenseBlock, gen: torch.Generator,
                cfg: ModelConfig) -> None:
    """Random weights of one :class:`DenseBlock` from ``gen``, in the
    order :meth:`DenseLM.init_` has always drawn them; unit norms."""
    init_attn_(block.attn, gen, cfg)
    if cfg.family == Family.MOE:
        init_moe(block.moe, gen, cfg)
    else:
        init_mlp_(block.mlp, gen, cfg)
    block.ln1.fill_(1.0)
    block.ln2.fill_(1.0)


def attn_weights(a: Attention, cfg: ModelConfig) -> dict:
    """The compute dict of one attention in ``cfg.dtype``: ``wqkv`` (the
    three input projections side by side), ``bqkv``, ``wo``."""
    dt = cfg.dtype

    def cat(*ws):
        return join([w.to(dt) for w in ws], dim=-1)

    w = {"wqkv": cat(a.wq, a.wk, a.wv), "wo": a.wo.to(dt)}
    if cfg.qkv_bias:
        w["bqkv"] = cat(a.bq, a.bk, a.bv)
    return w


def block_weights(block: DenseBlock, cfg: ModelConfig) -> dict:
    """The compute dict of one :class:`DenseBlock` that
    :func:`block_forward` and :func:`block_decode` read."""
    dt = cfg.dtype
    w = {"ln1": block.ln1.to(dt), "ln2": block.ln2.to(dt)}
    w.update(attn_weights(block.attn, cfg))
    if cfg.family == Family.MOE:
        w["moe"] = moe_weights(block.moe, cfg)
    else:
        w.update(mlp_weights(block.mlp, cfg))
    return w


# ------------------------------------------------------------------- blocks
def _moe_forward(w: dict, h: torch.Tensor, cfg: ModelConfig, mesh):
    """The MoE layer of a prefill block, as ``cfg.moe_impl`` says."""
    if cfg.moe_impl == "einsum":
        return moe_einsum(w, h, cfg)
    if cfg.moe_impl != "ep":
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")
    if mesh is None:
        raise ValueError("moe_impl='ep' needs the DeviceMesh to exchange "
                         "tokens over (mesh=)")
    from repro_torch.collectives.modes import CollectiveMode
    from repro_torch.collectives.moe_ep import local_experts, moe_ep
    mode = (CollectiveMode.HIERARCHICAL
            if cfg.moe_a2a_mode == "hierarchical" else CollectiveMode.DIRECT)
    return moe_ep(local_experts(w, mesh), h, cfg, mesh, mode=mode)


def block_forward(w: dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, *, prefix_len: int = 0,
                  mesh=None):
    """Training/prefill block over a whole sequence from position 0:
    ``(x, (k, v, aux))``.  The attention runs on the flash kernel, with
    the prefix-LM mask over the first ``prefix_len`` positions.
    ``mesh``: the ``DeviceMesh`` of ``moe_impl="ep"``, where x is this
    rank's data-parallel shard."""
    h = rmsnorm(x, w["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(w, h, cfg, positions)
    o = attn.flash_attend(q, k, v, prefix_len=prefix_len)
    x = x + attn.attn_output(w, o, cfg)
    h = rmsnorm(x, w["ln2"], cfg.norm_eps)
    if "moe" in w:
        y, aux = _moe_forward(w["moe"], h, cfg, mesh)
    else:
        y, aux = mlp(w, h, cfg), torch.zeros((), device=x.device)
    return x + y, (k, v, aux)


def block_decode(w: dict, x: torch.Tensor, cfg: ModelConfig,
                 cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int):
    """One-token decode against a filled KV cache, written in place.
    x ``[B,1,D]``; cache_k/v ``[B,Smax,Hkv,hd]``; pos the current
    position."""
    bsz = x.shape[0]
    h = rmsnorm(x, w["ln1"], cfg.norm_eps)
    positions = torch.full((bsz, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = attn.qkv_project(w, h, cfg, positions)
    ck, cv = attn.cache_update(cache_k, cache_v, k, v, pos)
    valid = torch.full((bsz,), pos + 1, dtype=torch.int32, device=x.device)
    o = attn.gqa_attend(q, ck, cv, causal=False, kv_valid_len=valid)
    x = x + attn.attn_output(w, o, cfg)
    h = rmsnorm(x, w["ln2"], cfg.norm_eps)
    y = moe_einsum(w["moe"], h, cfg)[0] if "moe" in w else mlp(w, h, cfg)
    return x + y, ck, cv


# ----------------------------------------------------------------------- LM
def _embed(w: dict, tokens: torch.Tensor,
           extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The token embeddings from the compute dict ``w``, after
    ``extra_embeds`` ``[B,P,D]`` (the VLM's patches) cast to
    ``cfg.dtype`` where given."""
    x = embed_rows(w["embed"], tokens)
    if extra_embeds is None:
        return x
    return torch.cat([extra_embeds.to(x.dtype), x], dim=1)


def _logits(w: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rmsnorm(x, w["ln_f"], cfg.norm_eps) @ w["head"]


def _positions(x: torch.Tensor) -> torch.Tensor:
    """``arange(S)`` for each row of ``x`` ``[B,S,...]``."""
    bsz, seq = x.shape[:2]
    return torch.arange(seq, dtype=torch.int32,
                        device=x.device)[None, :].expand(bsz, seq)


def _forward(w: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
             extra_embeds: Optional[torch.Tensor] = None,
             prefix_len: int = 0, mesh=None, logits_from: int = 0):
    """The whole-sequence forward over the compute dict ``w``, under the
    caller's grad mode, each block under :func:`checkpoint_wrap` (the
    reference's remat of its block scan); logits at the positions from
    ``logits_from`` on (each row's the same function as over the whole
    sequence)."""
    x = _embed(w, tokens, extra_embeds)
    positions = _positions(x)
    aux = torch.zeros((), device=x.device)
    block = checkpoint_wrap(block_forward, cfg)
    for wb in w["blocks"]:
        x, (_, _, a) = block(wb, x, cfg, positions, prefix_len=prefix_len,
                             mesh=mesh)
        aux = aux + a
    if logits_from:
        x = x[:, logits_from:].contiguous()
    return _logits(w, x, cfg), aux


@torch.no_grad()
def lm_apply(model: DenseLM, tokens: torch.Tensor, cfg: ModelConfig, *,
             extra_embeds: Optional[torch.Tensor] = None,
             prefix_len: int = 0, mesh=None):
    """tokens ``[B,S]`` -> (logits ``[B,P+S,Vp]`` in ``cfg.dtype``, aux
    loss), without gradients, over the cached compute copies.
    ``extra_embeds``: an optional ``[B,P,D]`` prefix put before the token
    embeddings; ``prefix_len``: B2's prefix-LM boundary.  ``mesh``: as
    :func:`block_forward`'s."""
    return _forward(model.weights(), tokens, cfg, extra_embeds=extra_embeds,
                    prefix_len=prefix_len, mesh=mesh)


def lm_train_apply(model: DenseLM, tokens: torch.Tensor, cfg: ModelConfig):
    """tokens ``[B,S]`` -> (logits ``[B,S,Vp]``, aux loss) under the
    caller's grad mode: the ``cfg.dtype`` compute dict is cast anew from
    the float32 masters on every call (``_cast``, not the serving cache),
    so the gradient reaches the masters and an optimizer step is seen by
    the next call."""
    return _forward(model._cast(), tokens, cfg)


class LMDecodeState(NamedTuple):
    cache: attn.KVCache    # stacked [L, ...]
    pos: int


def lm_make_state(cfg: ModelConfig, batch: int, max_len: int,
                  device=None) -> LMDecodeState:
    return LMDecodeState(cache=attn.init_cache(cfg, batch, max_len,
                                               device=device), pos=0)


@torch.no_grad()
def lm_prefill(model: DenseLM, tokens: torch.Tensor, cfg: ModelConfig,
               state: LMDecodeState, *,
               extra_embeds: Optional[torch.Tensor] = None,
               prefix_len: int = 0):
    """Fill the cache with the prompt (after ``extra_embeds``, as
    :func:`lm_apply`) from slot 0; returns (last-token logits
    ``[B,1,Vp]``, state)."""
    w = model.weights()
    x = _embed(w, tokens, extra_embeds)
    bsz, seq = x.shape[:2]
    positions = _positions(x)
    cache = state.cache
    for i, wb in enumerate(w["blocks"]):
        x, (k, v, _) = block_forward(wb, x, cfg, positions,
                                     prefix_len=prefix_len)
        attn.cache_update(cache.k[i], cache.v[i], k, v, 0)
    logits = _logits(w, x[:, -1:, :].contiguous(), cfg)
    length = torch.full((bsz,), seq, dtype=torch.int32, device=x.device)
    return logits, LMDecodeState(cache=cache._replace(length=length), pos=seq)


@torch.no_grad()
def lm_decode_step(model: DenseLM, token: torch.Tensor, cfg: ModelConfig,
                   state: LMDecodeState):
    """token ``[B,1]`` -> (logits ``[B,1,Vp]``, the next state)."""
    w = model.weights()
    x = _embed(w, token)
    cache = state.cache
    for i, wb in enumerate(w["blocks"]):
        x, _, _ = block_decode(wb, x, cfg, cache.k[i], cache.v[i], state.pos)
    return _logits(w, x, cfg), LMDecodeState(
        cache=cache._replace(length=cache.length + 1), pos=state.pos + 1)


__all__ = ["DenseBlock", "DenseLM", "LMDecodeState", "attn_weights",
           "block_decode", "block_forward", "block_weights", "init_attn_",
           "init_block_", "init_mlp_", "lm_apply", "lm_decode_step",
           "lm_make_state", "lm_prefill", "lm_train_apply"]

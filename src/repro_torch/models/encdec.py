"""Encoder-decoder backbone (whisper-large-v3 shape).

Counterpart of ``repro/models/encdec.py``.  The mel-spectrogram conv
frontend is a stub, as in the reference: the model consumes precomputed
frame embeddings ``[B, frames, D]``.  The encoder is a non-causal
self-attention stack without RoPE; each decoder block runs causal
self-attention with RoPE, cross-attention over the encoder states (no
RoPE) and a plain GELU MLP (``act="gelu"``, ``glu=False``).

The reference scans stacked parameters; here the blocks are
``nn.ModuleList``\\ s with float32 masters under the reference's names
(``enc_blocks.{i}.attn.wq``, ``dec_blocks.{i}.cross_attn.wk``, ...).
Which attention runs where:

* the encoder's self-attention and the prefill's cross-attention run on
  the flash kernel B2 with ``causal=False`` (cross-attention has ``Sq !=
  Skv``);
* the decoder's self-attention in prefill runs on B2, causal;
* a decode step runs the plain ``gqa_attend`` over the self cache and
  over the cross K/V, which the prefill projects once per layer
  (:func:`precompute_cross_kv`, the reference's hoist).

Every norm runs on B4.  The cross-attention's compute weights keep the q
projection apart from the joined k/v projections, so the prefill
projects the decoder tokens and the encoder frames only for what each
is used for.  Prefill and decode write the self cache in place.

Training (:func:`encdec_train_apply`) runs the same forward over a
compute dict cast anew from the masters, with gradients: B2's and B4's
autograd Functions run their backward kernels.  The serving functions
read the no-grad cache (``weights()``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import (CastCache, ModelConfig,
                                       checkpoint_wrap, dense_init,
                                       embed_rows, join, normal, rmsnorm,
                                       split_product)
from repro_torch.models.mlp import MLP, mlp, mlp_weights, param
from repro_torch.models.transformer import (Attention, DenseBlock,
                                            _positions, attn_weights,
                                            block_weights, init_attn_,
                                            init_block_, init_mlp_)


class DecBlock(nn.Module):
    """One decoder block: self-attention (``ln1``), cross-attention
    (``ln_x``) and the MLP (``ln2``), each residual."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = param((cfg.d_model,), cfg, device, 1.0)
        self.self_attn = Attention(cfg, device)
        self.ln_x = param((cfg.d_model,), cfg, device, 1.0)
        self.cross_attn = Attention(cfg, device)
        self.ln2 = param((cfg.d_model,), cfg, device, 1.0)
        self.mlp = MLP(cfg, device)


class EncDecLM(CastCache):
    """Embedding, frame positions, ``n_encoder_layers`` encoder blocks
    (:class:`~repro_torch.models.transformer.DenseBlock`), the encoder's
    final norm, ``n_layers`` :class:`DecBlock`, the final norm and the LM
    head; parameters allocated on ``device``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.embed = param((cfg.vocab_padded, d), cfg, device)
        self.pos_enc = param((cfg.encoder_frames, d), cfg, device)
        self.enc_blocks = nn.ModuleList(DenseBlock(cfg, device)
                                        for _ in range(cfg.n_encoder_layers))
        self.enc_ln = param((d,), cfg, device, 1.0)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, device)
                                        for _ in range(cfg.n_layers))
        self.ln_f = param((d,), cfg, device, 1.0)
        self.lm_head = param((d, cfg.vocab_padded), cfg, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "EncDecLM":
        """Random weights from ``gen``, laid out as the reference's
        ``init_encdec``: embed and frame positions N(0, 0.02^2),
        projections N(0, 1/fan_in), the LM head N(0, 0.02^2), unit norms.
        Each tensor is drawn on the host and copied to the module's device
        as it is drawn."""
        cfg, pd = self.cfg, self.cfg.param_dtype
        self.embed.copy_(normal(gen, self.embed.shape, 0.02, pd))
        self.pos_enc.copy_(normal(gen, self.pos_enc.shape, 0.02, pd))
        for block in self.enc_blocks:
            init_block_(block, gen, cfg)
        self.enc_ln.fill_(1.0)
        for block in self.dec_blocks:
            init_attn_(block.self_attn, gen, cfg)
            init_attn_(block.cross_attn, gen, cfg)
            init_mlp_(block.mlp, gen, cfg)
            for ln in (block.ln1, block.ln_x, block.ln2):
                ln.fill_(1.0)
        self.ln_f.fill_(1.0)
        self.lm_head.copy_(dense_init(gen, *self.lm_head.shape, pd,
                                      scale=0.02))
        self._cw = None
        return self

    def _cast(self) -> dict:
        cfg, dt = self.cfg, self.cfg.dtype
        dec = []
        for block in self.dec_blocks:
            c = block.cross_attn
            cross = {"wq": c.wq.to(dt), "wo": c.wo.to(dt),
                     "wkv": join([c.wk.to(dt), c.wv.to(dt)], dim=-1)}
            if cfg.qkv_bias:
                cross["bq"] = c.bq.to(dt)
                cross["bkv"] = join([c.bk.to(dt), c.bv.to(dt)], dim=-1)
            w = {"ln1": block.ln1.to(dt), "ln_x": block.ln_x.to(dt),
                 "ln2": block.ln2.to(dt),
                 "self": attn_weights(block.self_attn, cfg), "cross": cross}
            w.update(mlp_weights(block.mlp, cfg))
            dec.append(w)
        return {"embed": self.embed.to(dt), "pos_enc": self.pos_enc.to(dt),
                "enc": [block_weights(b, cfg) for b in self.enc_blocks],
                "enc_ln": self.enc_ln.to(dt), "dec": dec,
                "ln_f": self.ln_f.to(dt), "head": self.lm_head.to(dt)}


# ------------------------------------------------------------------ encoder
def _enc_block(blk: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One encoder block: non-causal attention without RoPE, the MLP."""
    h = rmsnorm(x, blk["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(blk, h, cfg, None, rope=False)
    x = x + attn.attn_output(
        blk, attn.flash_attend(q, k, v, causal=False), cfg)
    h = rmsnorm(x, blk["ln2"], cfg.norm_eps)
    return x + mlp(blk, h, cfg)


def _encode(w: dict, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder over the compute dict ``w``, under the caller's grad
    mode, each block under :func:`checkpoint_wrap`."""
    n_frames = frames.shape[1]
    x = frames.to(cfg.dtype) + w["pos_enc"][:n_frames]
    block = checkpoint_wrap(_enc_block, cfg)
    for blk in w["enc"]:
        x = block(blk, x, cfg)
    return rmsnorm(x, w["enc_ln"], cfg.norm_eps)


@torch.no_grad()
def encode(model: EncDecLM, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames ``[B, F, D]`` (the stub conv output) -> encoder states
    ``[B, F, D]`` in ``cfg.dtype``."""
    return _encode(model.weights(), frames, cfg)


# ------------------------------------------------------------------ decoder
def _cross_q(w: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention queries ``[B,S,H,hd]`` of decoder states ``h``."""
    q = h @ w["wq"]
    if cfg.qkv_bias:
        q = q + w["bq"]
    q = attn.heads_layout(q, cfg.n_heads, over_positions=True)
    return q.reshape(*h.shape[:2], cfg.n_heads, cfg.hd)


def _cross_kv(w: dict, enc: torch.Tensor, cfg: ModelConfig):
    """Cross-attention keys and values ``[B,F,Hkv,hd]`` of the encoder
    states."""
    n = cfg.n_kv_heads * cfg.hd
    k, v = (attn.heads_layout(t, cfg.n_kv_heads) for t in split_product(
        enc, w["wkv"], (n, n), w["bkv"] if cfg.qkv_bias else None))
    shape = (*enc.shape[:2], cfg.n_kv_heads, cfg.hd)
    return k.reshape(shape), v.reshape(shape)


def _dec_block(w: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor):
    """One decoder block over a whole sequence from position 0, against
    the cross K/V ``xk``, ``xv``: ``(x, (k, v))``, the self-attention's
    keys and values for the cache."""
    h = rmsnorm(x, w["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(w["self"], h, cfg, positions)
    x = x + attn.attn_output(w["self"], attn.flash_attend(q, k, v), cfg)
    h = rmsnorm(x, w["ln_x"], cfg.norm_eps)
    q2 = _cross_q(w["cross"], h, cfg)
    x = x + attn.attn_output(
        w["cross"], attn.flash_attend(q2, xk, xv, causal=False), cfg)
    h = rmsnorm(x, w["ln2"], cfg.norm_eps)
    return x + mlp(w, h, cfg), (k, v)


def _logits(w: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rmsnorm(x, w["ln_f"], cfg.norm_eps) @ w["head"]


def _dec_layer(w: dict, x: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> torch.Tensor:
    """One decoder block with its cross K/V projected from ``enc``, so
    that a recomputed block projects them again, as the reference's."""
    return _dec_block(w, x, cfg, positions,
                      *_cross_kv(w["cross"], enc, cfg))[0]


def _apply(w: dict, frames: torch.Tensor, tokens: torch.Tensor,
           cfg: ModelConfig):
    """The encoder, every decoder block's cross K/V and the decoder over
    the compute dict ``w``, under the caller's grad mode, each encoder
    block and each decoder block with its cross K/V under
    :func:`checkpoint_wrap`."""
    enc = _encode(w, frames, cfg)
    x = embed_rows(w["embed"], tokens)
    positions = _positions(tokens)
    layer = checkpoint_wrap(_dec_layer, cfg)
    for blk in w["dec"]:
        x = layer(blk, x, enc, cfg, positions)
    return _logits(w, x, cfg), torch.zeros((), device=x.device)


@torch.no_grad()
def encdec_apply(model: EncDecLM, frames: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig):
    """Teacher-forced decoder logits ``[B,S,Vp]`` and a zero aux loss,
    without gradients, over the cached compute copies."""
    return _apply(model.weights(), frames, tokens, cfg)


def encdec_train_apply(model: EncDecLM, frames: torch.Tensor,
                       tokens: torch.Tensor, cfg: ModelConfig):
    """As :func:`encdec_apply` under the caller's grad mode, over a
    compute dict cast anew from the float32 masters (``_cast``), so that
    every master, ``pos_enc``, the encoder and ``enc_ln`` included, gets
    its gradient."""
    return _apply(model._cast(), frames, tokens, cfg)


# ------------------------------------------------------------------ serving
class EncDecState(NamedTuple):
    cache: attn.KVCache     # decoder self-attn cache [L, ...]
    enc: torch.Tensor       # encoder states [B, F, D]
    cross_k: torch.Tensor   # cross-attn keys   [L, B, F, Hkv, hd]
    cross_v: torch.Tensor   # cross-attn values [L, B, F, Hkv, hd]
    pos: int


def encdec_make_state(cfg: ModelConfig, batch: int, max_len: int,
                      enc: Optional[torch.Tensor] = None,
                      device=None) -> EncDecState:
    if enc is None:
        enc = torch.zeros(batch, cfg.encoder_frames, cfg.d_model,
                          dtype=cfg.dtype, device=device)
    shape = (cfg.n_layers, batch, cfg.encoder_frames, cfg.n_kv_heads, cfg.hd)
    return EncDecState(
        cache=attn.init_cache(cfg, batch, max_len, device=device), enc=enc,
        cross_k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        cross_v=torch.zeros(shape, dtype=cfg.dtype, device=device), pos=0)


@torch.no_grad()
def precompute_cross_kv(model: EncDecLM, enc: torch.Tensor, cfg: ModelConfig,
                        cross_k: torch.Tensor, cross_v: torch.Tensor):
    """The cross-attention K/V of every decoder layer over the encoder
    states ``enc``, projected once (the reference's hoist out of the
    decode step) and written into ``cross_k``, ``cross_v`` ``[L, B, F,
    Hkv, hd]``, which it returns."""
    for i, blk in enumerate(model.weights()["dec"]):
        k, v = _cross_kv(blk["cross"], enc, cfg)
        cross_k[i].copy_(k)
        cross_v[i].copy_(v)
    return cross_k, cross_v


@torch.no_grad()
def encdec_prefill(model: EncDecLM, tokens: torch.Tensor, cfg: ModelConfig,
                   state: EncDecState):
    """Fill the decoder's self cache with the prompt from slot 0 and the
    cross K/V from ``state.enc`` (which must already hold the encoder
    output); returns (last-token logits ``[B,1,Vp]``, state)."""
    w = model.weights()
    x = embed_rows(w["embed"], tokens)
    bsz, seq = tokens.shape
    positions = _positions(tokens)
    cache = state.cache
    xk, xv = precompute_cross_kv(model, state.enc, cfg, state.cross_k,
                                 state.cross_v)
    for i, blk in enumerate(w["dec"]):
        x, (k, v) = _dec_block(blk, x, cfg, positions, xk[i], xv[i])
        attn.cache_update(cache.k[i], cache.v[i], k, v, 0)
    logits = _logits(w, x[:, -1:, :].contiguous(), cfg)
    length = torch.full((bsz,), seq, dtype=torch.int32, device=x.device)
    return logits, state._replace(cache=cache._replace(length=length),
                                  pos=seq)


@torch.no_grad()
def encdec_decode_step(model: EncDecLM, token: torch.Tensor, cfg: ModelConfig,
                       state: EncDecState):
    """token ``[B,1]`` -> (logits ``[B,1,Vp]``, the next state)."""
    w = model.weights()
    x = embed_rows(w["embed"], token)
    bsz, pos = x.shape[0], state.pos
    cache = state.cache
    positions = torch.full((bsz, 1), pos, dtype=torch.int32, device=x.device)
    valid = torch.full((bsz,), pos + 1, dtype=torch.int32, device=x.device)
    for i, blk in enumerate(w["dec"]):
        h = rmsnorm(x, blk["ln1"], cfg.norm_eps)
        q, k, v = attn.qkv_project(blk["self"], h, cfg, positions)
        ck, cv = attn.cache_update(cache.k[i], cache.v[i], k, v, pos)
        o = attn.gqa_attend(q, ck, cv, causal=False, kv_valid_len=valid)
        x = x + attn.attn_output(blk["self"], o, cfg)
        h = rmsnorm(x, blk["ln_x"], cfg.norm_eps)
        o2 = attn.gqa_attend(_cross_q(blk["cross"], h, cfg),
                             state.cross_k[i], state.cross_v[i], causal=False)
        x = x + attn.attn_output(blk["cross"], o2, cfg)
        h = rmsnorm(x, blk["ln2"], cfg.norm_eps)
        x = x + mlp(blk, h, cfg)
    return _logits(w, x, cfg), state._replace(
        cache=cache._replace(length=cache.length + 1), pos=pos + 1)


__all__ = ["DecBlock", "EncDecLM", "EncDecState", "encdec_apply",
           "encdec_decode_step", "encdec_make_state", "encdec_prefill",
           "encdec_train_apply", "encode", "precompute_cross_kv"]

"""Zamba2-style hybrid: a Mamba2 backbone and one SHARED attention block.

Counterpart of ``repro/models/hybrid.py``.  One set of attention and MLP
weights (the "shared block", arXiv:2411.15242) is applied every
``cfg.shared_attn_period`` Mamba2 layers::

    super-block a (a = 0 .. n_super-1):
        [shared attention block]   (skipped for a == 0)
        `period` Mamba2 layers
    trailing:  n_layers % period Mamba2 layers

The reference scans stacked parameters; here the layers are
``nn.ModuleList``\\ s run in a Python loop, with float32 masters under the
reference's names (``main.{a}.{j}.ln``, ``main.{a}.{j}.mamba.w_z``,
``shared.attn.wq``, ``trailing.{r}.mamba...``).  The shared block is the
dense family's :class:`~repro_torch.models.transformer.DenseBlock`: its
prefill attention runs causal on the flash kernel B2, a decode step
attends over the cache in plain PyTorch, as the dense family does.  Each
Mamba2 layer's within-chunk SSD block runs on B3 and every norm on B4.

The decode state keeps the reference's layout (Mamba states ``[n_super,
period, B, ...]`` and ``[max(rem, 1), B, ...]``, the shared block's
cache ``[n_super, B, Smax, Hkv, hd]`` with slot 0 unused), and prefill
and decode write it in place: a state is consumed by the call that
takes it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import (CastCache, ModelConfig, dense_init,
                                       normal, rmsnorm)
from repro_torch.models.mamba2 import Mamba2State, init_mamba2_state
from repro_torch.models.mlp import param
from repro_torch.models.ssm_lm import SSMLayer
from repro_torch.models.transformer import (DenseBlock, _positions,
                                            block_decode, block_forward,
                                            block_weights, init_block_)


def hybrid_layout(cfg: ModelConfig):
    """(n_super, period, n_trailing, n_apps)."""
    period = cfg.shared_attn_period
    n_super = cfg.n_layers // period
    rem = cfg.n_layers % period
    return n_super, period, rem, max(n_super - 1, 0)


class HybridLM(CastCache):
    """Embedding, ``n_super x period`` Mamba2 layers, the shared block,
    ``rem`` trailing Mamba2 layers, the final norm and the LM head;
    parameters allocated on ``device``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        n_super, period, rem, _ = hybrid_layout(cfg)
        self.cfg = cfg
        self.embed = param((cfg.vocab_padded, cfg.d_model), cfg, device)
        self.main = nn.ModuleList(
            nn.ModuleList(SSMLayer(cfg, device) for _ in range(period))
            for _ in range(n_super))
        self.shared = DenseBlock(cfg, device)
        self.trailing = nn.ModuleList(SSMLayer(cfg, device)
                                      for _ in range(rem))
        self.ln_f = param((cfg.d_model,), cfg, device, 1.0)
        self.lm_head = param((cfg.d_model, cfg.vocab_padded), cfg, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "HybridLM":
        """Random weights from ``gen``, laid out as the reference's
        ``init_hybrid``: embed N(0, 0.02^2), the Mamba2 blocks as
        ``init_mamba2``, the shared block as ``init_attn``/``init_mlp``,
        the LM head N(0, 0.02^2), unit norms.  Each tensor is drawn on the
        host and copied to the module's device as it is drawn."""
        cfg, pd = self.cfg, self.cfg.param_dtype
        self.embed.copy_(normal(gen, self.embed.shape, 0.02, pd))
        for layer in self.mamba_layers():
            layer.ln.fill_(1.0)
            layer.mamba.init_(gen)
        init_block_(self.shared, gen, cfg)
        self.ln_f.fill_(1.0)
        self.lm_head.copy_(dense_init(gen, *self.lm_head.shape, pd,
                                      scale=0.02))
        self._cw = None
        return self

    def mamba_layers(self) -> list:
        """Every Mamba2 layer in forward order: the super-blocks', then
        the trailing ones."""
        return [layer for sup in self.main for layer in sup] + \
            list(self.trailing)

    def _cast(self) -> dict:
        dt = self.cfg.dtype
        return {"embed": self.embed.to(dt), "head": self.lm_head.to(dt),
                "ln_f": self.ln_f.to(dt),
                "shared": block_weights(self.shared, self.cfg),
                "ln": [layer.ln.to(dt) for layer in self.mamba_layers()]}


def _logits(w: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rmsnorm(x, w["ln_f"], cfg.norm_eps) @ w["head"]


def _write(dst: Mamba2State, src: Mamba2State) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


def _groups(model: HybridLM, lns: list) -> list:
    """The layers in forward order: ``(a, [(layer, cast ln, state
    index), ...])`` per super-block ``a`` (the shared block runs before
    its Mamba2 layers where ``a`` > 0), then ``(None, trailing)``;
    ``lns``: the cast norms of every Mamba2 layer in forward order."""
    n_super, period, rem, _ = hybrid_layout(model.cfg)
    groups = [(a, [(model.main[a][j], lns[a * period + j], ("main", a, j))
                   for j in range(period)]) for a in range(n_super)]
    return groups + [(None, [(model.trailing[r], lns[n_super * period + r],
                              ("trailing", r)) for r in range(rem)])]


def _state_of(state: "HybridDecodeState", idx) -> Mamba2State:
    """The views of one Mamba2 layer's state in the stacked state."""
    tree = state.mamba_main if idx[0] == "main" else state.mamba_trailing
    return Mamba2State(*(t[idx[1:]] for t in tree))


def _forward(model: HybridLM, tokens: torch.Tensor, cfg: ModelConfig,
             state=None, *, train: bool = False):
    """The hidden states after every layer of a sequence from position 0,
    and the compute dict they were made with, under the caller's grad
    mode; with ``state``, the Mamba states and the shared block's cache
    slots are written into it.  ``train``: every compute copy is cast
    anew from the masters (``_cast``, with gradients; the shared block's
    once, so its gradient sums over its applications), else the serving
    caches."""
    w = model._cast() if train else model.weights()
    x = w["embed"][tokens.long()]
    positions = _positions(tokens)
    for a, layers in _groups(model, w["ln"]):
        if a:
            x, (k, v, _) = block_forward(w["shared"], x, cfg, positions)
            if state is not None:
                attn.cache_update(state.attn_cache.k[a],
                                  state.attn_cache.v[a], k, v, 0)
        for layer, ln, idx in layers:
            st = None if state is None else _state_of(state, idx)
            y, new = layer.mamba(rmsnorm(x, ln, cfg.norm_eps), st,
                                 w=layer.mamba._cast() if train else None)
            if st is not None:
                _write(st, new)
            x = x + y
    return x, w


@torch.no_grad()
def hybrid_apply(model: HybridLM, tokens: torch.Tensor, cfg: ModelConfig):
    """Teacher-forced logits ``[B,S,Vp]`` and a zero aux loss, without
    gradients, over the cached compute copies."""
    x, w = _forward(model, tokens, cfg)
    return _logits(w, x, cfg), torch.zeros((), device=x.device)


def hybrid_train_apply(model: HybridLM, tokens: torch.Tensor,
                       cfg: ModelConfig):
    """The reference's ``hybrid_apply`` under the caller's grad mode,
    over compute copies cast anew from the float32 masters, so the
    gradient reaches the masters and an optimizer step is seen by the
    next call."""
    x, w = _forward(model, tokens, cfg, train=True)
    return _logits(w, x, cfg), torch.zeros((), device=x.device)


# ------------------------------------------------------------------ serving
class HybridDecodeState(NamedTuple):
    mamba_main: Mamba2State      # [n_super, period, B, ...]
    mamba_trailing: Mamba2State  # [max(rem, 1), B, ...] (rem may be 0)
    attn_cache: attn.KVCache     # [n_super, B, Smax, Hkv, hd] (slot 0 unused)
    pos: int


def hybrid_make_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> HybridDecodeState:
    n_super, period, rem, _ = hybrid_layout(cfg)
    one = init_mamba2_state(cfg, batch, device)

    def tile(pref):
        return Mamba2State(*(torch.zeros(pref + tuple(t.shape), dtype=t.dtype,
                                         device=device) for t in one))

    return HybridDecodeState(
        mamba_main=tile((n_super, period)),
        mamba_trailing=tile((max(rem, 1),)),
        attn_cache=attn.init_cache(cfg, batch, max_len, n_layers=n_super,
                                   device=device),
        pos=0)


@torch.no_grad()
def hybrid_prefill(model: HybridLM, tokens: torch.Tensor, cfg: ModelConfig,
                   state: HybridDecodeState):
    """Process the prompt from position 0, filling the Mamba states and
    the shared block's cache slots 1 .. n_super-1; returns (last-token
    logits ``[B,1,Vp]``, state)."""
    bsz, seq = tokens.shape
    x, w = _forward(model, tokens, cfg, state)
    logits = _logits(w, x[:, -1:, :].contiguous(), cfg)
    length = torch.full((bsz,), seq, dtype=torch.int32, device=x.device)
    return logits, state._replace(
        attn_cache=state.attn_cache._replace(length=length), pos=seq)


@torch.no_grad()
def hybrid_decode_step(model: HybridLM, token: torch.Tensor,
                       cfg: ModelConfig, state: HybridDecodeState):
    """token ``[B,1]`` -> (logits ``[B,1,Vp]``, the next state).  O(1) in
    context for the Mamba backbone; the shared block attends over its
    cache slot of each application."""
    w = model.weights()
    x = w["embed"][token.long()]
    cache = state.attn_cache
    for a, layers in _groups(model, w["ln"]):
        if a:
            x, _, _ = block_decode(w["shared"], x, cfg, cache.k[a],
                                   cache.v[a], state.pos)
        for layer, ln, idx in layers:
            st = _state_of(state, idx)
            y, new = layer.mamba.decode(rmsnorm(x, ln, cfg.norm_eps), st)
            _write(st, new)
            x = x + y
    return _logits(w, x, cfg), state._replace(
        attn_cache=cache._replace(length=cache.length + 1),
        pos=state.pos + 1)


__all__ = ["HybridDecodeState", "HybridLM", "hybrid_apply",
           "hybrid_decode_step", "hybrid_layout", "hybrid_make_state",
           "hybrid_prefill", "hybrid_train_apply"]

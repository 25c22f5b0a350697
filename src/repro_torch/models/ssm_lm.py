"""Pure-SSM language model (mamba2-130m): embed + Mamba2 blocks.

Counterpart of ``repro/models/ssm_lm.py``.  The reference scans stacked
per-layer parameters; here the layers are an ``nn.ModuleList`` run in a
Python loop, and the decode state holds one :class:`Mamba2State` per
layer.  The embedding is tied: logits are ``rmsnorm(x, ln_f) @
embed.T`` over the padded vocabulary, and callers drop the pad.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models.common import (CastCache, ModelConfig,
                                       checkpoint_wrap, embed_rows, normal,
                                       rmsnorm)
from repro_torch.models.mamba2 import (Mamba2Block, Mamba2State,
                                       init_mamba2_state)


class SSMLayer(nn.Module):
    """One residual layer: ``h + mamba(rmsnorm(h, ln))``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.param_dtype,
                                          device=device),
                               requires_grad=False)
        self.mamba = Mamba2Block(cfg, device)


class SSMLM(CastCache):
    """Embedding, ``n_layers`` :class:`SSMLayer` and the final norm,
    with float32 master weights under the reference's names."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.zeros(cfg.vocab_padded, cfg.d_model,
                        dtype=cfg.param_dtype), requires_grad=False)
        self.blocks = nn.ModuleList(SSMLayer(cfg)
                                    for _ in range(cfg.n_layers))
        self.ln_f = nn.Parameter(torch.ones(cfg.d_model,
                                            dtype=cfg.param_dtype),
                                 requires_grad=False)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "SSMLM":
        """Random weights from ``gen``, laid out as the reference's
        ``init_ssm_lm``."""
        self.embed.copy_(normal(gen, self.embed.shape, 0.02,
                                self.cfg.param_dtype))
        for layer in self.blocks:
            layer.ln.fill_(1.0)
            layer.mamba.init_(gen)
        self.ln_f.fill_(1.0)
        self._cw = None
        return self

    def _cast(self) -> dict:
        dt_ = self.cfg.dtype
        return {"embed": self.embed.to(dt_), "ln_f": self.ln_f.to(dt_),
                "ln": [layer.ln.to(dt_) for layer in self.blocks]}


def _embed(w: dict, tokens: torch.Tensor) -> torch.Tensor:
    return embed_rows(w["embed"], tokens)


def _logits(w: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(x, w["ln_f"], cfg.norm_eps)
    return x @ w["embed"].T


def _layer(layer: SSMLayer, x: torch.Tensor, ln: torch.Tensor, wb,
           cfg: ModelConfig) -> torch.Tensor:
    """One layer: the norm, the Mamba2 mixer over the compute dict ``wb``
    and the residual."""
    y, _ = layer.mamba(rmsnorm(x, ln, cfg.norm_eps), w=wb)
    return x + y


def _apply(model: SSMLM, tokens: torch.Tensor, cfg: ModelConfig,
           w: dict, blocks: list):
    """Logits ``[B,S,Vp]`` and a zero aux loss over the compute dicts
    ``w`` (the model's) and ``blocks`` (one per Mamba2 block, or None for
    its serving cache), under the caller's grad mode, each layer under
    :func:`checkpoint_wrap` (the reference's remat of its layer scan)."""
    x = _embed(w, tokens)
    layer_fn = checkpoint_wrap(_layer, cfg)
    for ln, layer, wb in zip(w["ln"], model.blocks, blocks):
        x = layer_fn(layer, x, ln, wb, cfg)
    return _logits(w, x, cfg), torch.zeros((), device=x.device)


@torch.no_grad()
def ssm_lm_apply(model: SSMLM, tokens: torch.Tensor, cfg: ModelConfig):
    """Teacher-forced logits ``[B,S,Vp]`` and a zero aux loss, without
    gradients, over the cached compute copies."""
    return _apply(model, tokens, cfg, model.weights(),
                  [None] * len(model.blocks))


def ssm_lm_train_apply(model: SSMLM, tokens: torch.Tensor,
                       cfg: ModelConfig):
    """The reference's ``ssm_lm_apply`` under the caller's grad mode:
    every compute copy is cast anew from the float32 masters (``_cast``,
    not the serving cache), so the gradient reaches the masters and an
    optimizer step is seen by the next call."""
    return _apply(model, tokens, cfg, model._cast(),
                  [layer.mamba._cast() for layer in model.blocks])


class SSMDecodeState(NamedTuple):
    states: list           # one Mamba2State per layer
    pos: int


def ssm_make_state(cfg: ModelConfig, batch: int, max_len: int = 0,
                   device=None) -> SSMDecodeState:
    return SSMDecodeState(
        states=[init_mamba2_state(cfg, batch, device)
                for _ in range(cfg.n_layers)], pos=0)


@torch.no_grad()
def ssm_prefill(model: SSMLM, tokens: torch.Tensor, cfg: ModelConfig,
                state: SSMDecodeState):
    """Logits of the last position ``[B,1,Vp]`` and the state after
    ``tokens``."""
    w = model.weights()
    x = _embed(w, tokens)
    new_states = []
    for ln, layer, st in zip(w["ln"], model.blocks, state.states):
        y, new_st = layer.mamba(rmsnorm(x, ln, cfg.norm_eps), st)
        x = x + y
        new_states.append(new_st)
    logits = _logits(w, x[:, -1:, :].contiguous(), cfg)
    return logits, SSMDecodeState(states=new_states,
                                  pos=state.pos + tokens.shape[1])


@torch.no_grad()
def ssm_decode_step(model: SSMLM, token: torch.Tensor, cfg: ModelConfig,
                    state: SSMDecodeState):
    """Logits ``[B,1,Vp]`` for one token ``[B,1]`` and the next state."""
    w = model.weights()
    x = _embed(w, token)
    new_states = []
    for ln, layer, st in zip(w["ln"], model.blocks, state.states):
        y, new_st = layer.mamba.decode(rmsnorm(x, ln, cfg.norm_eps), st)
        x = x + y
        new_states.append(new_st)
    return _logits(w, x, cfg), SSMDecodeState(states=new_states,
                                              pos=state.pos + 1)


__all__ = ["Mamba2State", "SSMDecodeState", "SSMLM", "SSMLayer",
           "ssm_decode_step", "ssm_lm_apply", "ssm_lm_train_apply",
           "ssm_make_state", "ssm_prefill"]

"""Mixture-of-Experts layer (GShard-style dense dispatch + shared experts).

Counterpart of ``repro/models/moe.py``.  Two dispatch implementations,
as in the reference:

  * ``einsum`` (:func:`moe_einsum`, the default and the serving path):
    capacity-bounded one-hot dispatch and combine einsums over groups of
    ``MOE_GROUP`` tokens.  Their products are plain ``torch.einsum``;
    a gather-based dispatch is perf work (ROADMAP B).

  * the expert-parallel path (:func:`repro_torch.collectives.moe_ep.
    moe_ep`): local top-k, all-to-all token exchange (DIRECT or
    HIERARCHICAL schedule), dense per-expert matmuls, all-to-all back.

Router: softmax gating in float32, top-k, the load-balancing auxiliary
loss (Switch/GShard style), optional always-on shared experts
(qwen2-moe).

:class:`MoE` holds the float32 masters under the reference's names
(``router [D, E]`` always float32, ``w_in``/``w_gate [E, D, F]``,
``w_out [E, F, D]``, ``shared``); :func:`moe_weights` casts them to the
compute dict the functions read: the router stays float32, ``w_in`` and
``w_gate`` sit side by side as ``w_in_gate [E, D, 2F]``.

Ties in the top-k: ``jax.lax.top_k`` puts the lower index first among
equal values, and ``torch.topk`` promises no order.  :func:`topk`
takes the first ``k`` of a stable descending sort, so among equal
probabilities the lower expert index comes first, as in the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (ModelConfig, activation, constrain,
                                       dense_init, dp_spec, is_sharded, join,
                                       normal, split_product)
from repro_torch.models.mlp import MLP, mlp, mlp_weights, param
from repro_torch.sharding.local import moe_per_rank

MOE_GROUP = 512  # tokens per dispatch group (capacity is per group)


class MoE(nn.Module):
    """One MoE layer's parameters, allocated on ``device``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert or cfg.d_ff
        self.router = param((d, e), cfg, device, dtype=torch.float32)
        self.w_in = param((e, d, f), cfg, device)
        self.w_gate = param((e, d, f), cfg, device)
        self.w_out = param((e, f, d), cfg, device)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, device, d_ff=f * cfg.n_shared_experts)


@torch.no_grad()
def init_moe(m: MoE, gen: torch.Generator, cfg: ModelConfig) -> MoE:
    """Random weights from ``gen``, laid out as the reference's
    ``init_moe``: router N(0, 1/D) in float32, ``w_in`` and ``w_gate``
    N(0, 1/D), ``w_out`` N(0, 1/F), the shared experts as a dense MLP."""
    pd = cfg.param_dtype
    d, f = m.w_in.shape[1], m.w_in.shape[2]
    m.router.copy_(dense_init(gen, d, m.router.shape[1], torch.float32))
    for w in (m.w_in, m.w_gate):
        w.copy_(normal(gen, w.shape, 1.0 / math.sqrt(d), pd))
    m.w_out.copy_(normal(gen, m.w_out.shape, 1.0 / math.sqrt(f), pd))
    if cfg.n_shared_experts:
        s = m.shared
        s.w_in.copy_(dense_init(gen, *s.w_in.shape, pd))
        s.w_out.copy_(dense_init(gen, *s.w_out.shape, pd))
        if cfg.glu:
            s.w_gate.copy_(dense_init(gen, *s.w_gate.shape, pd))
    return m


def moe_weights(m: MoE, cfg: ModelConfig) -> dict:
    """The compute dict of layer ``m``: the router in float32, the
    experts in ``cfg.dtype``."""
    dt = cfg.dtype
    w = {"router": m.router.float(),
         "w_in_gate": join([m.w_in.to(dt), m.w_gate.to(dt)], dim=-1),
         "w_out": m.w_out.to(dt)}
    if cfg.n_shared_experts:
        w["shared"] = mlp_weights(m.shared, cfg)
    return w


def router_probs(w: dict, x: torch.Tensor, cfg: ModelConfig):
    """fp32 router. x ``[T,D]`` -> probs ``[T,E]``."""
    return torch.softmax(x.float() @ w["router"], dim=-1)


def topk(probs: torch.Tensor, k: int):
    """The ``k`` largest values along the last axis and their indices,
    largest first, ties to the lower index (``jax.lax.top_k``'s order)."""
    v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def gates(topv: torch.Tensor) -> torch.Tensor:
    """The top-k probabilities renormalised to sum to 1 per token."""
    return topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)


def topk_dispatch(probs: torch.Tensor, cfg: ModelConfig, capacity: int):
    """Capacity-bounded top-k assignment.

    probs ``[G, S, E]`` (grouped tokens).  Returns dispatch ``[G,S,E,C]``
    in {0, 1}, combine ``[G,S,E,C]`` (gate-weighted), and the aux loss."""
    n_groups, seq, n_exp = probs.shape
    topv, topi = topk(probs, cfg.top_k)                  # [G,S,k]
    topv = gates(topv)
    slot_ids = torch.arange(capacity, device=probs.device)
    counts = torch.zeros((n_groups, n_exp), dtype=torch.int64,
                         device=probs.device)
    disp = torch.zeros((n_groups, seq, n_exp, capacity),
                       dtype=torch.float32, device=probs.device)
    comb = torch.zeros_like(disp)
    for j in range(cfg.top_k):                           # k is small (<=8)
        oh = F.one_hot(topi[..., j], n_exp)              # [G,S,E]
        pos = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]
        keep = (pos < capacity) & (oh > 0)
        # one-hot of the slot; a dropped (token, expert) has none
        sel = (slot_ids == torch.where(keep, pos, capacity)[..., None]) \
            .float()                                     # [G,S,E,C]
        disp = disp + sel
        comb = comb + sel * topv[..., j][..., None, None]
        counts = counts + oh.sum(dim=1)
    # load-balance auxiliary loss (Switch): E * mean_e(frac_e * prob_e)
    me = probs.mean(dim=(0, 1))                          # [E]
    top1 = F.one_hot(topi[..., 0], n_exp).float().mean(dim=(0, 1))
    aux = n_exp * torch.sum(me * top1)
    return disp, comb, aux


def expert_ffn(w: dict, xe: torch.Tensor, cfg: ModelConfig,
               spec: str = "egcd") -> torch.Tensor:
    """The gated per-expert FFN on tokens ``xe`` laid out as ``spec``
    (the expert first, the model dim last)."""
    out = spec[:-1] + "f"
    f = w["w_out"].shape[1]
    h, g = split_product(
        xe, w["w_in_gate"], (f, f),
        product=lambda a, b: torch.einsum(f"{spec},edf->{out}", a, b))
    h = activation(g, cfg.act) * h
    return torch.einsum(f"{out},efd->{spec}", h, w["w_out"])


def moe_einsum(w: dict, x: torch.Tensor, cfg: ModelConfig):
    """x ``[B,S,D]`` -> (y, aux_loss).  GShard-style grouped dense
    dispatch.  On DTensors it runs per rank
    (:func:`~repro_torch.sharding.local.moe_per_rank`)."""
    if is_sharded(x):
        y, aux = moe_per_rank(_moe_einsum, w, x, cfg)
        return constrain(y, dp_spec(y), None, None), constrain(aux)
    return _moe_einsum(w, x, cfg)


def _moe_einsum(w: dict, x: torch.Tensor, cfg: ModelConfig,
                experts: slice | None = None):
    """``experts``: the experts whose weights ``w`` holds (every one by
    default): the dispatch and combine keep their slots only."""
    bsz, seq, d = x.shape
    dt = cfg.dtype
    n_tok = bsz * seq
    xg = x.reshape(n_tok, d)
    g = max(1, n_tok // MOE_GROUP)
    while n_tok % g:
        g -= 1
    sg = n_tok // g
    probs = router_probs(w, xg, cfg).reshape(g, sg, cfg.n_experts)
    capacity = max(cfg.top_k, int(math.ceil(
        sg * cfg.top_k * 1.25 / cfg.n_experts)))
    disp, comb, aux = topk_dispatch(probs, cfg, capacity)
    if experts is not None:
        disp, comb = disp[:, :, experts], comb[:, :, experts]
    xt = xg.reshape(g, sg, d)
    # dispatch: [g,s,e,c] x [g,s,d] -> [e,g,c,d]
    xe = torch.einsum("gsec,gsd->egcd", disp.to(dt), xt)
    ye = expert_ffn(w, xe, cfg)
    y = torch.einsum("gsec,egcd->gsd", comb.to(dt), ye).reshape(bsz, seq, d)
    if cfg.n_shared_experts:
        y = y + mlp(w["shared"], x, cfg)
    return y, aux.float()


__all__ = ["MOE_GROUP", "MoE", "expert_ffn", "gates", "init_moe",
           "moe_einsum", "moe_weights", "router_probs", "topk",
           "topk_dispatch"]

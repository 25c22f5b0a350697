"""Expert-parallel MoE over all-to-all — the counterpart of the
reference's shard_map path (``repro/collectives/moe_ep.py``).

The einsum path's dispatch and combine tensors cost O(T*E*C*D); the EP
path routes tokens with a local scatter (O(T*D)), exchanges only real
token payloads with all-to-all over the expert-parallel dim, and runs
dense per-expert matmuls: the MoE communication pattern the paper's
alltoall analysis is about, with the DIRECT vs HIERARCHICAL schedule
choice (Algorithm 1) applied to the all-to-all.

:func:`moe_ep` runs per rank, on a ``DeviceMesh`` whose dims carry the
reference's names: it takes that rank's data-parallel shard of x and
its ``E/ep`` experts (:func:`local_experts`), and needs ``n_experts %
ep == 0``.  The weights are a compute dict of
:func:`repro_torch.models.moe.moe_weights`.

C9 (ROADMAP C): the reference's HIERARCHICAL exchange is
``alltoall_hierarchical(buf, "pod", ep_axis)``, whose second all-to-all
crosses pods although the experts are sharded only over the ep dim; on
any mesh with a pod dim of size > 1 tokens then reach experts that are
not theirs.  The port keeps that exchange bit for bit, for parity; a
fix belongs in both packages.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.collectives.allreduce import dim_size, span_group
from repro_torch.collectives.alltoall import (alltoall_direct,
                                              alltoall_hierarchical)
from repro_torch.collectives.modes import CollectiveMode
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import expert_ffn, gates, router_probs, topk
from repro_torch.models.mlp import mlp

DP_DIMS = ("pod", "data")


def _local_dispatch(x: torch.Tensor, probs: torch.Tensor, cfg: ModelConfig,
                    capacity: int):
    """Local top-k -> per-expert buckets.

    x ``[T, D]``; probs ``[T, E]``.  Returns (buffer ``[E, C, D]``, gates
    ``[T, k]``, expert_idx ``[T, k]``, slot_idx ``[T, k]`` (-1: dropped),
    aux)."""
    n_tok, d = x.shape
    n_exp, k = cfg.n_experts, cfg.top_k
    topv, topi = topk(probs, k)                          # [T, k]
    topv = gates(topv)
    rows = torch.arange(n_tok, device=x.device)
    counts = torch.zeros(n_exp, dtype=torch.int64, device=x.device)
    buffer = torch.zeros((n_exp, capacity, d), dtype=x.dtype,
                         device=x.device)
    slots = []
    for j in range(k):                                   # k <= 8
        e = topi[:, j]                                   # [T]
        oh = F.one_hot(e, n_exp)                         # [T, E]
        pos = (torch.cumsum(oh, dim=0) - oh)[rows, e] + counts[e]
        keep = pos < capacity
        slot = torch.where(keep, pos, capacity)          # OOB -> dropped
        buffer.index_put_((e, slot.clamp(0, capacity - 1)),
                          torch.where(keep[:, None], x, 0),
                          accumulate=True)
        slots.append(torch.where(keep, slot, -1))
        counts = counts + oh.sum(dim=0)
    me = probs.mean(dim=0)
    top1 = F.one_hot(topi[:, 0], n_exp).float().mean(dim=0)
    aux = n_exp * torch.sum(me * top1)
    return buffer, topv, topi, torch.stack(slots, 1), aux


def _combine(back: torch.Tensor, g: torch.Tensor, eidx: torch.Tensor,
             slots: torch.Tensor, capacity: int) -> torch.Tensor:
    """Gather each (token, choice) slot of ``back`` ``[E, C, D]``,
    weighted by its gate; a dropped choice adds 0."""
    y = torch.zeros((eidx.shape[0], back.shape[-1]), dtype=back.dtype,
                    device=back.device)
    for j in range(eidx.shape[1]):
        slot = slots[:, j]
        val = back[eidx[:, j], slot.clamp(0, capacity - 1)]
        val = torch.where((slot >= 0)[:, None], val, 0)
        y = y + g[:, j][:, None].to(val.dtype) * val
    return y


def local_experts(w: dict, mesh, ep_dim: str = "model") -> dict:
    """This rank's ``E/ep`` experts of the compute dict ``w`` (router
    and shared experts whole)."""
    ep = dim_size(mesh, ep_dim)
    n_loc = w["w_in_gate"].shape[0] // ep
    r = mesh.get_local_rank(ep_dim)
    return {**w, "w_in_gate": w["w_in_gate"][r * n_loc:(r + 1) * n_loc],
            "w_out": w["w_out"][r * n_loc:(r + 1) * n_loc]}


def moe_ep(w: dict, x: torch.Tensor, cfg: ModelConfig, mesh, *,
           mode: CollectiveMode = CollectiveMode.DIRECT,
           ep_dim: str = "model", capacity_factor: float = 1.25):
    """Drop-in replacement for :func:`repro_torch.models.moe.moe_einsum`
    on one rank: x ``[B/n_dp, S, D]`` is the rank's data-parallel shard
    (replicated over ``ep_dim``), ``w`` holds its ``E/ep`` experts.
    Returns (y of x's shape, the aux loss averaged over the
    data-parallel dims and ``ep_dim``)."""
    names = mesh.mesh_dim_names
    if ep_dim not in names:
        raise ValueError(f"the mesh {names} has no expert-parallel dim "
                         f"{ep_dim!r}")
    ep = dim_size(mesh, ep_dim)
    n_exp, k = cfg.n_experts, cfg.top_k
    n_loc = n_exp // ep
    if n_exp % ep or w["w_in_gate"].shape[0] != n_loc:
        raise ValueError(f"{n_exp} experts over {ep_dim} of {ep}: each "
                         f"rank needs {n_exp / ep} of them, it holds "
                         f"{w['w_in_gate'].shape[0]}")
    bl, seq, d = x.shape
    xt = x.reshape(-1, d)
    capacity = max(k, int(math.ceil(bl * seq * k * capacity_factor
                                    / n_exp)))
    hier = mode == CollectiveMode.HIERARCHICAL and "pod" in names

    def exchange(t):
        if hier:                        # C9: the second phase crosses pods
            return alltoall_hierarchical(t, mesh, "pod", ep_dim)
        return alltoall_direct(t, mesh, ep_dim)

    probs = router_probs(w, xt, cfg)
    buf, g, eidx, slots, aux = _local_dispatch(xt, probs, cfg, capacity)
    # [E, C, D] -> exchange -> [ep, E_loc, C, D] -> [E_loc, ep*C, D]
    recv = exchange(buf).reshape(ep, n_loc, capacity, d) \
        .transpose(0, 1).reshape(n_loc, ep * capacity, d)
    out = expert_ffn(w, recv, cfg, "ecd")
    out = out.reshape(n_loc, ep, capacity, d).transpose(0, 1) \
        .reshape(n_exp, capacity, d)
    back = exchange(out)
    y = _combine(back, g, eidx, slots, capacity).reshape(bl, seq, d)
    group = tuple(a for a in DP_DIMS if a in names) + (ep_dim,)
    n_group = math.prod(dim_size(mesh, a) for a in group)
    dist.all_reduce(aux, group=span_group(mesh, group))
    aux = aux / n_group
    if cfg.n_shared_experts:
        y = y + mlp(w["shared"], x, cfg)
    return y, aux.float()


def moe_ep_ref(w: dict, x: torch.Tensor, cfg: ModelConfig,
               capacity_factor: float = 1.25):
    """Single-device oracle: the same dispatch math, no collectives; ``w``
    holds every expert."""
    bsz, seq, d = x.shape
    xt = x.reshape(-1, d)
    n_tok = xt.shape[0]
    capacity = max(cfg.top_k, int(math.ceil(
        n_tok * cfg.top_k * capacity_factor / cfg.n_experts)))
    probs = router_probs(w, xt, cfg)
    buf, g, eidx, slots, aux = _local_dispatch(xt, probs, cfg, capacity)
    out = expert_ffn(w, buf, cfg, "ecd")
    y = _combine(out, g, eidx, slots, capacity).reshape(bsz, seq, d)
    if cfg.n_shared_experts:
        y = y + mlp(w["shared"], x, cfg)
    return y, aux.float()

"""All-to-all schedules on ``torch.distributed`` — MoE expert-parallel
token exchange.

Counterpart of ``repro/collectives/alltoall.py``.  Each rank calls them
on its own tensor; dim 0 is cut into as many equal chunks as the group
has ranks, chunk i goes to the group's rank i, and the chunks received
are concatenated in rank order (the reference's ``tiled=True``
``all_to_all`` with ``split_axis = concat_axis = 0``).

DIRECT:        one all-to-all over the expert-parallel dim.  With
               experts sharded across pods, token payloads cross the
               slow links in many small per-peer messages.

HIERARCHICAL:  phase 1 exchanges within the pod (fast links), so that
               each chip aggregates all pod-local tokens bound for its
               cross-pod peer group; phase 2 crosses pods with fewer,
               larger messages.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.collectives.allreduce import span_group


def alltoall_direct(x: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    """x ``[n*k, ...]`` split over the ``n`` ranks of mesh dim ``dim``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=span_group(mesh, dim))
    return out


def alltoall_hierarchical(x: torch.Tensor, mesh, pod_dim: str,
                          inner_dim: str) -> torch.Tensor:
    """x ``[P*I*k, ...]``.  Phase 1: all-to-all over the inner dim;
    phase 2: all-to-all over the pod dim with aggregated payloads."""
    x = alltoall_direct(x, mesh, inner_dim)     # within the pod
    return alltoall_direct(x, mesh, pod_dim)    # across pods

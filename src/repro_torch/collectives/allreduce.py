"""All-reduce schedules on ``torch.distributed`` — DIRECT vs HIERARCHICAL.

Counterpart of ``repro/collectives/allreduce.py``.  The reference runs
its schedules inside ``shard_map`` over named mesh axes; here every
rank calls them on its own tensor, over a
``torch.distributed.device_mesh.DeviceMesh`` whose dims carry the
reference's axis names (``"pod"``, ``"data"``, ``"model"``).  NCCL
carries them on the card, gloo on the CPU.

DIRECT:        one all-reduce over the group that spans every given
               dim.  On a multi-pod mesh the ring spans pods, so the
               slow pod-boundary links carry the full 2(n-1)/n share.

HIERARCHICAL:  reduce-scatter over the intra-pod dim, all-reduce over
               the pod dim on the 1/inner shard (slow links carry
               bytes/inner_size), all-gather back over the intra-pod
               dim.  One extra phase in exchange for offloading the
               scarce links: the minimal/non-minimal trade the paper
               arbitrates per message.

Each schedule returns a new tensor and leaves its input as it was.
"""

from __future__ import annotations

import math
import weakref

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.collectives.modes import CollectiveMode

#: process groups spanning several mesh dims: {mesh: {dims: group}},
#: dropped with the mesh
_SPANS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def dim_size(mesh, dim: str) -> int:
    """Size of mesh dim ``dim``."""
    return mesh.size(mesh.mesh_dim_names.index(dim))


def span_group(mesh, dims):
    """The process group of this rank over mesh dims ``dims``: the ranks
    that share its coordinates on every other dim.  One dim is the
    mesh's own group; several are made once per mesh with
    ``dist.new_subgroups_by_enumeration`` (every rank of the mesh must
    reach the first call), in ascending rank order, which is row-major
    over ``dims``."""
    dims = (dims,) if isinstance(dims, str) else tuple(dims)
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    spans = _SPANS.setdefault(mesh, {})
    if dims not in spans:
        names = list(mesh.mesh_dim_names)
        at = [names.index(d) for d in dims]
        rest = [i for i in range(len(names)) if i not in at]
        ranks = mesh.mesh.permute(*rest, *at).reshape(
            -1, math.prod(mesh.mesh.shape[i] for i in at))
        spans[dims], _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return spans[dims]


def _flatten_pad(x: torch.Tensor, n: int):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, pad


def allreduce_direct(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """One-phase sum over (possibly several) mesh dims."""
    out = x.clone()
    dist.all_reduce(out, group=span_group(mesh, dims))
    return out


def allreduce_hierarchical(x: torch.Tensor, mesh, pod_dim: str,
                           inner_dim: str) -> torch.Tensor:
    """RS(inner) -> AR(pod) -> AG(inner).

    Works for any tensor shape (flattens and pads to the inner size)."""
    inner = dim_size(mesh, inner_dim)
    flat, pad = _flatten_pad(x.contiguous(), inner)
    shard = flat.new_empty(flat.numel() // inner)
    dist.reduce_scatter_tensor(shard, flat, group=span_group(mesh, inner_dim))
    dist.all_reduce(shard, group=span_group(mesh, pod_dim))
    full = torch.empty_like(flat)
    dist.all_gather_into_tensor(full, shard,
                                group=span_group(mesh, inner_dim))
    if pad:
        full = full[:-pad]
    return full.reshape(x.shape)


def grad_allreduce(grads: dict, mesh, *, mode, pod_dim: str = "pod",
                   inner_dim: str = "data") -> dict:
    """Mean-reduce a dict of gradients across the data-parallel dims with
    the chosen schedule.

    Each rank holds its data-parallel replica (one per (pod, data)
    position); the dict is returned averaged."""
    has_pod = pod_dim in mesh.mesh_dim_names
    dp_dims = (pod_dim, inner_dim) if has_pod else (inner_dim,)
    n_dp = math.prod(dim_size(mesh, d) for d in dp_dims)

    def reduce_leaf(g):
        if mode == CollectiveMode.HIERARCHICAL and has_pod:
            g = allreduce_hierarchical(g, mesh, pod_dim, inner_dim)
        else:
            g = allreduce_direct(g, mesh, dp_dims)
        return g / n_dp

    return {name: reduce_leaf(g) for name, g in grads.items()}

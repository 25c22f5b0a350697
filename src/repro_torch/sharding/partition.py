"""Partitioning rules: parameter name -> dimension roles -> mesh dims.

Counterpart of ``repro/sharding/partition.py``, with DTensor placements
in place of ``NamedSharding``.  Role assignment (Megatron-style TP over
the "model" dim; DP over ("pod", "data")):

    vocab, heads, ff, inner, experts  ->  "model"   (TP / EP)
    d (hidden)                        ->  the dp dims if ShardingPolicy.fsdp
    batch                             ->  ("pod", "data") / ("data",)

Every rule is divisibility-checked against the mesh; a dim that does not
divide falls back to replication.  The reference stacks a layer's
leaves (``blocks.attn.wq [L, D, H hd]``) and pads the stacked dims with
None; the port's layers are unstacked (``blocks.{i}.attn.wq [D, H hd]``,
the hybrid's ``main.{a}.{j}.…`` for the reference's ``[n_super,
period, …]`` prefix), so the rules apply to the leaf as it is.  Numeric
name parts (layer indices) are skipped when the rules read a name.

A spec is a tuple with one entry per tensor dim: None, a mesh dim name,
or a tuple of names (the reference's ``PartitionSpec`` entries).
:func:`placements` turns it into one DTensor placement per mesh dim:
``Shard(d)`` on each mesh dim that tensor dim ``d`` names (a tuple
shards ``d`` over its dims in mesh order, row-major as the reference's
multi-axis entries), ``Replicate()`` elsewhere.  ``mesh`` is a
``torch.distributed.device_mesh.DeviceMesh``, or anything with its
``shape`` and ``mesh_dim_names``: the rules read only those, so they
need no process group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.models.common import ModelConfig

# parameter name -> dimension roles (rightmost dims)
_ROLE_RULES = {
    "embed": ("vocab", "d"),
    "lm_head": ("d", "vocab"),
    "pos_enc": (None, "d"),
    "wq": ("d", "heads"), "wk": ("d", "heads"), "wv": ("d", "heads"),
    "wo": ("heads", "d"),
    "bq": ("heads",), "bk": ("heads",), "bv": ("heads",),
    "w_in": ("d", "ff"), "w_gate": ("d", "ff"), "w_out": ("ff", "d"),
    "router": ("d", None),
    # mamba2 (split projections; see models/mamba2.py docstring)
    "w_z": ("d", "inner"), "w_x": ("d", "inner"),
    "w_b": ("d", None), "w_c": ("d", None), "w_dt": ("d", None),
    "conv_x_w": (None, "inner"), "conv_x_b": ("inner",),
    "conv_b_w": (None, None), "conv_c_w": (None, None),
    "conv_bb": (None,), "conv_cb": (None,),
    "a_log": (None,), "d_skip": (None,), "dt_bias": (None,),
    "norm_g": ("inner",),
    "out_proj": ("inner", "d"),
}
# MoE expert tensors carry an extra leading experts dim
_MOE_RULES = {
    "w_in": ("experts", "d", "ff"),
    "w_gate": ("experts", "d", "ff"),
    "w_out": ("experts", "ff", "d"),
}
_REPLICATED_NAMES = {"ln1", "ln2", "ln_f", "ln_x", "ln", "enc_ln", "gamma"}


@dataclass(frozen=True)
class ShardingPolicy:
    tp_axis: str = "model"
    dp_axes: tuple = ("data",)        # ("pod","data") on multi-pod meshes
    fsdp: bool = False                # shard the "d" role over dp axes
    #: EP: MoE expert dim over tp_axis (True) vs ff sharding (False)
    expert_parallel: bool = True

    def role_axis(self, role: Optional[str]):
        if role is None:
            return None
        if role in ("vocab", "heads", "ff", "inner"):
            return self.tp_axis
        if role == "experts":
            return self.tp_axis if self.expert_parallel else None
        if role == "d":
            return self.dp_axes if self.fsdp else None
        if role == "batch":
            return self.dp_axes
        return None


def mesh_sizes(mesh) -> dict:
    """``{dim name: size}`` of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def placements(spec, mesh) -> tuple:
    """One placement per mesh dim for ``spec`` (one entry per tensor
    dim: None, a mesh dim name or a tuple of names)."""
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            out[list(mesh.mesh_dim_names).index(a)] = Shard(dim)
    return tuple(out)


def spec_of(placements_, mesh, ndim: int) -> tuple:
    """The spec of ``placements_`` on a tensor of ``ndim`` dims: each
    entry the tuple of mesh dims (in mesh order) that shard that dim,
    None where none does (the inverse of :func:`placements`)."""
    dims: list = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, placements_):
        if isinstance(p, Shard):
            dims[p.dim % ndim].append(name)
    return tuple(tuple(d) if d else None for d in dims)


def _name_parts(name: str) -> list:
    """The non-numeric parts of a dotted parameter name."""
    return [p for p in name.split(".") if not p.isdigit()]


def leaf_spec(name: str, shape, mesh, policy: ShardingPolicy) -> tuple:
    """The spec of parameter ``name`` of ``shape`` (the reference's
    ``_spec_for_leaf`` on an unstacked leaf)."""
    parts = _name_parts(name)
    leaf = parts[-1] if parts else None
    in_moe = "moe" in parts
    ndim = len(shape)
    if leaf in _REPLICATED_NAMES or leaf is None:
        return (None,) * ndim
    roles = None
    if in_moe and leaf in _MOE_RULES and ndim >= 3:
        roles = _MOE_RULES[leaf]
    elif leaf in _ROLE_RULES:
        roles = _ROLE_RULES[leaf]
    if roles is None:
        return (None,) * ndim
    pad = ndim - len(roles)
    if pad < 0:  # scalar-ish leaf with fewer dims than roles
        roles = roles[-ndim:] if ndim else ()
        pad = 0
    spec = [None] * pad
    used: set = set()
    for i, role in enumerate(roles):
        axis = policy.role_axis(role)
        dim = shape[pad + i]
        flat = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        if (axis is not None and dim % _axis_size(mesh, axis) == 0
                and not (used & set(flat))):
            spec.append(tuple(axis) if isinstance(axis, list) else axis)
            used |= set(flat)
        else:
            spec.append(None)
    return tuple(spec)


def default_policy(mesh) -> ShardingPolicy:
    dp = (("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",))
    return ShardingPolicy(tp_axis="model", dp_axes=dp)


def _named(model_or_named) -> dict:
    """``{name: tensor}`` of a module's parameters, or the dict given."""
    if isinstance(model_or_named, torch.nn.Module):
        return dict(model_or_named.named_parameters())
    return dict(model_or_named)


def param_specs(model_or_named_params, cfg: ModelConfig, mesh,
                policy: ShardingPolicy | None = None) -> dict:
    """``{parameter name: placements}`` for a module (its
    ``named_parameters()``) or a dict of named tensors."""
    policy = policy or default_policy(mesh)
    return {n: placements(leaf_spec(n, tuple(t.shape), mesh, policy), mesh)
            for n, t in _named(model_or_named_params).items()}


def input_specs_sharding(specs: dict, cfg: ModelConfig, mesh,
                         policy: ShardingPolicy | None = None) -> dict:
    """Placements for the input_specs dict (tokens/labels/frames/patches):
    batch over dp axes (when divisible), everything else replicated."""
    policy = policy or default_policy(mesh)
    dp = policy.dp_axes
    dp_size = _axis_size(mesh, dp)
    out = {}
    for k, v in specs.items():
        spec = [None] * len(v.shape)
        if v.shape and v.shape[0] % dp_size == 0 and v.shape[0] > 1:
            spec[0] = tuple(dp)
        out[k] = placements(spec, mesh)
    return out


def state_leaf_spec(shape, mesh, policy: ShardingPolicy) -> tuple:
    """The spec of one decode-state leaf of ``shape`` (the reference's
    rules, by rank):

      * batch dim (``ndim - 4``; ``0`` or ``ndim - 3`` below 4 dims) ->
        dp axes when divisible and above 1;
      * KV-cache head dim -> tp when divisible, and then, when the batch
        is not sharded, the sequence dim -> dp (long-context decode);
        else the sequence dim -> tp;
      * 2-3 dims: the last (channel) dim -> tp when divisible."""
    tp = policy.tp_axis
    tp_size = mesh_sizes(mesh)[tp]
    dp = tuple(policy.dp_axes)
    dp_size = _axis_size(mesh, dp)
    ndim = len(shape)
    spec: list = [None] * ndim
    if ndim == 0:
        return ()
    # KV caches: [..., B, S, Hkv, hd]; mamba ssm: [..., B, H, N, P];
    # conv states: [..., B, K-1, C]
    if ndim >= 4:
        b_dim = ndim - 4
        s_dim, h_dim = ndim - 3, ndim - 2
        batch_sharded = shape[b_dim] % dp_size == 0 and shape[b_dim] > 1
        if batch_sharded:
            spec[b_dim] = dp
        if shape[h_dim] % tp_size == 0:
            spec[h_dim] = tp
            if not batch_sharded and shape[s_dim] % dp_size == 0 \
                    and shape[s_dim] > dp_size:
                spec[s_dim] = dp
        elif shape[s_dim] % tp_size == 0:
            spec[s_dim] = tp
    elif ndim >= 2:
        b_dim = 0 if ndim == 2 else ndim - 3
        c_dim = ndim - 1
        if shape[b_dim] % dp_size == 0 and shape[b_dim] > 1:
            spec[b_dim] = dp
        if shape[c_dim] % tp_size == 0:
            spec[c_dim] = tp
    return tuple(spec)


def _map_tensors(tree, fn):
    """``tree`` (NamedTuples, tuples, lists, dicts) with ``fn`` applied
    to each tensor leaf; other leaves become None."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_tensors(v, fn) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return None


def decode_state_specs(state, cfg: ModelConfig, mesh,
                       policy: ShardingPolicy | None = None):
    """Placements for a decode state (KV caches, SSM and conv states):
    ``state``'s structure with each tensor leaf's placements
    (:func:`state_leaf_spec`), None at its other leaves (the port keeps
    positions as host ints)."""
    policy = policy or default_policy(mesh)
    return _map_tensors(state, lambda t: placements(
        state_leaf_spec(tuple(t.shape), mesh, policy), mesh))

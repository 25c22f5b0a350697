"""Elastic resharding: restore a checkpoint onto a DIFFERENT mesh.

Counterpart of ``repro/ckpt/elastic.py``.  Checkpoints store unsharded
(host-gathered) arrays, so elasticity is a placement problem, not a data
problem: :func:`reshard_checkpoint` places every leaf with the sharding
rules evaluated against the NEW mesh (divisibility fallbacks included),
letting a job restart on a shrunken or grown set of cards, or onto a
differently shaped model dim after re-planning TP.  Every rank holds the
restored arrays, so each takes its own shard and nothing is sent.

A leaf's rules are read from the innermost dict key on its path: the
checkpoint trees of training, ``(model.state_dict(), AdamWState)``, key
every parameter and both moments by the parameter's name, as the
reference's trees key them by the leaf's name; a leaf under no key (the
optimizer's step) is replicated.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.sharding.partition import (ShardingPolicy, default_policy,
                                            leaf_spec, placements)


def _place(leaf, name, mesh, policy):
    if isinstance(leaf, np.ndarray) or np.isscalar(leaf):
        leaf = torch.from_numpy(np.array(leaf))
    spec = (leaf_spec(name, tuple(leaf.shape), mesh, policy)
            if name is not None else (None,) * leaf.dim())
    return distribute_tensor(leaf, mesh, placements(spec, mesh),
                             src_data_rank=None)


def _walk(tree, name, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, k if isinstance(k, str) else name, fn)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_walk(v, name, fn) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(v, name, fn) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor, np.generic)):
        return fn(tree, name)
    return tree


def reshard_checkpoint(tree, cfg, new_mesh, *,
                       policy: ShardingPolicy | None = None):
    """Place restored host arrays (NumPy or CPU tensors) onto
    ``new_mesh`` with fresh placements: ``tree``'s structure with a
    DTensor at each array leaf, on the mesh's device.  Other leaves (a
    host int step) stay as they are."""
    policy = policy or default_policy(new_mesh)
    return _walk(tree, None,
                 lambda leaf, name: _place(leaf, name, new_mesh, policy))

"""Production mesh construction.

Counterpart of ``repro/launch/mesh.py``.  FUNCTIONS, not module-level
constants: importing this module starts no process group and touches no
device.  A mesh needs a ``torch.distributed`` world of its size, started
by the caller (the dry run starts a fake one of 256 or 512 ranks; a real
job's launcher, NCCL's); both functions raise without it.  The device
type is the caller's: ``"cuda"`` (the default) on the cards, ``"cpu"``
for the dry run's host ranks.  Rank r sits at the row-major mesh
coordinate r, which is the reference's device r.
"""

from __future__ import annotations

import math


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 ("data","model") single pod; 2x16x16 ("pod","data","model")
    for the 512-chip two-pod configuration."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_for(shape, axes, device_type=device_type)


def make_mesh_for(shape: tuple, axes: tuple, *, device_type: str = "cuda"):
    """Elastic variant: build whatever mesh the ElasticPlanner chose.
    Raises unless a world of ``prod(shape)`` ranks is running."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a torch.distributed world "
                           f"of {math.prod(shape)} ranks; none is running")
    if dist.get_world_size() != math.prod(shape):
        raise RuntimeError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                           f"the world has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)

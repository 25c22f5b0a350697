"""Per-chip hardware figures and the pod-boundary test of a collective.

Counterpart of the first part of ``repro/analysis/roofline.py``.  The
reference's ``V5E`` is a TPU spec and is not carried over; the port's
spec is the card it runs on, ``H100``, from NVIDIA's H100 SXM5 80GB
datasheet.  Its figures are datasheet values, not measurements.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops: float          # per chip, bf16
    hbm_bw: float              # bytes/s per chip
    ici_bw: float              # bytes/s per chip per link class (intra-pod)
    dcn_bw: float              # bytes/s per chip (pod boundary)


H100 = HwSpec(
    name="h100-sxm5-80gb",
    # datasheet: "BF16 Tensor Core 1,979 teraFLOPS" with sparsity; dense
    # is half of it
    peak_flops=989e12,
    # datasheet: "GPU memory bandwidth 3.35TB/s"
    hbm_bw=3.35e12,
    # datasheet: "Interconnect NVLink: 900GB/s" (both directions); one
    # direction is half of it
    ici_bw=450e9,
    # ConnectX-7 datasheet: one NDR InfiniBand port per GPU, 400Gb/s
    dcn_bw=50e9,
)


def classify_collective(group0_devices, mesh_shape) -> str:
    """'cross_pod' if the replica group spans pod boundaries, else 'intra'.

    Device ids are row-major over mesh_shape; for ("pod","data","model")
    the pod coordinate is id // (data*model)."""
    if len(mesh_shape) < 3 or not group0_devices:
        return "intra"
    per_pod = int(np.prod(mesh_shape[1:]))
    pods = {d // per_pod for d in group0_devices}
    return "cross_pod" if len(pods) > 1 else "intra"

"""Beyond the paper — Algorithm 1 arbitrating collective schedules on a
multi-pod H100 cluster.

Sweeps message sizes through the AppAwareSelector on the 2 x 256 mesh
cost model and reports the crossover, plus the pod-boundary (DCN) bytes
saved against always-DIRECT for a llama3-8b-sized gradient reduction:
the analogue of Fig. 8's "Application-Aware sends X% via Default".

Counterpart of ``benchmarks/tpu_selector.py``: the cost model takes
``hw``, by default the port's ``H100`` (NVIDIA datasheet link rates, not
measurements).  At that spec the stall term is 0 for both modes (ROADMAP
C): below the policy's cumulative-size gate the first sizes go DIRECT,
the first decision past it, made before any observation, takes
HIERARCHICAL (4 KiB), and every later one DIRECT; so the crossover row
reads 4 KiB and the saving is the first bucket's.  Given the same
``HwSpec`` values the sweep is the reference's, size for size.

    PYTHONPATH=src python -m repro_torch.benchmarks.h100_selector
"""

from __future__ import annotations

import numpy as np

from repro_torch.analysis.roofline import H100, HwSpec, param_counts_analytic
from repro_torch.benchmarks.common import emit
from repro_torch.collectives.modes import CollectiveMode
from repro_torch.collectives.selector import (AppAwareSelector, ICICostModel,
                                              MeshSpec)
from repro_torch.configs import get_config

MESH = MeshSpec(n_pods=2, inner_chips=256)


def crossover_sweep(hw: HwSpec = H100) -> list:
    """(size, mode) for sizes 1 KiB to 1 GiB, emitted with the predicted
    latency (µs) of the chosen mode; then the first size routed
    hierarchically (0 where none is)."""
    cm = ICICostModel(MESH, hw=hw)
    sel = AppAwareSelector(cm)
    flips = []
    for size in [1 << k for k in range(10, 31)]:
        m = sel.select(size)
        sel.observe_predicted(size)
        flips.append((size, m))
        emit(f"h100_selector.sweep.{size}B",
             cm.predict(size, m).latency_cycles / 1e3, m.value)
    first_h = next((s for s, m in flips
                    if m == CollectiveMode.HIERARCHICAL), None)
    emit("h100_selector.crossover_bytes", float(first_h or 0),
         "first size routed hierarchically")
    return flips


def grad_reduce_savings(hw: HwSpec = H100) -> dict:
    """llama3-8b gradient buckets: DCN wire bytes (GiB) DIRECT,
    HIERARCHICAL and app-aware."""
    cfg = get_config("llama3-8b")
    total, _ = param_counts_analytic(cfg)
    grad_bytes = total * 2  # bf16 wire
    sel = AppAwareSelector(ICICostModel(MESH, hw=hw))
    bucket = 32 << 20
    n_buckets = int(np.ceil(grad_bytes / bucket))
    direct_dcn = hier_dcn = aware_dcn = 0.0
    n, p, i = MESH.total, MESH.n_pods, MESH.inner_chips
    for _ in range(n_buckets):
        d = 2 * (n - 1) / n * bucket                    # full ring on DCN
        h = 2 * (p - 1) / p * (bucket / i)              # shard on DCN
        direct_dcn += d
        hier_dcn += h
        m = sel.select(bucket)
        sel.observe_predicted(bucket)
        aware_dcn += h if m == CollectiveMode.HIERARCHICAL else d
    saving = 100 * (1 - aware_dcn / max(direct_dcn, 1e-9))
    emit("h100_selector.llama3_grad.direct_dcn_gb", direct_dcn / 2**30, "")
    emit("h100_selector.llama3_grad.hier_dcn_gb", hier_dcn / 2**30, "")
    emit("h100_selector.llama3_grad.appaware_dcn_gb", aware_dcn / 2**30,
         f"saving={saving:.1f}%")
    return {"direct_gib": direct_dcn / 2**30, "hier_gib": hier_dcn / 2**30,
            "app_aware_gib": aware_dcn / 2**30, "saving_pct": saving}


def main(full: bool = False, hw: HwSpec = H100):
    crossover_sweep(hw)
    grad_reduce_savings(hw)


if __name__ == "__main__":
    main(full=True)

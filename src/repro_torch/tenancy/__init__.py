"""repro_torch.tenancy — multi-tenant interference on one Dragonfly.

K co-running jobs (node-disjoint allocations, shared links) interleaved
into ONE batched simulator via TenantSegments; per-tenant observables
split back out; victim slowdown scored against run-alone baselines.
See docs/interference.md.

    from repro_torch.tenancy import (InterferenceEngine, TenancyMix, Workload,
                               sweep)

    mix = TenancyMix("pp-vs-a2a", (
        Workload("victim", "pingpong", 32, arm=RoutingMode.ADAPTIVE_3),
        Workload("aggr", "alltoall", 64, arm=RoutingMode.ADAPTIVE_0)))
    res = InterferenceEngine(topo).run_mix(mix, rounds=4)
    res.victim_slowdown      # mix time / run-alone time
"""

from repro_torch.tenancy.engine import (InterferenceEngine, MixResult,
                                  TenantReport, arm_label,
                                  run_mixes_lockstep)
from repro_torch.tenancy.spec import TenancyMix, Workload
from repro_torch.tenancy.sweep import sweep

__all__ = [
    "InterferenceEngine", "MixResult", "TenantReport", "arm_label",
    "TenancyMix", "Workload", "sweep", "run_mixes_lockstep",
]

# repro_torch.collectives — the paper's technique, applied to collective
# schedules on torch.distributed (NCCL on the card, gloo on the CPU);
# counterpart of repro.collectives.
#
# Aries routing modes map to collective *schedules*:
#   minimal / high-bias  ->  DIRECT: one-phase flat collectives (fewest
#                            phases; every byte crosses the slow pod links)
#   adaptive / spread    ->  HIERARCHICAL: pod-local reduce-scatter, cross-
#                            pod exchange on shards, pod-local all-gather
#                            (more phases/hops; scarce links carry 1/N)
#
# selector.AppAwareSelector runs the paper's Algorithm 1 verbatim on these
# two modes, with (L, s) from the ICI cost model, or synthesized from the
# link-class byte counts of a traced step (trace_counters.py, the
# counterpart of the reference's HLO-derived HloCounterBackend).

from repro_torch.collectives.modes import CollectiveMode, mode_for_routing
from repro_torch.collectives.allreduce import (
    allreduce_direct, allreduce_hierarchical, grad_allreduce,
)
from repro_torch.collectives.alltoall import (alltoall_direct,
                                              alltoall_hierarchical)
from repro_torch.collectives.selector import AppAwareSelector, ICICostModel
from repro_torch.collectives.trace_counters import TraceCounterBackend

__all__ = [
    "CollectiveMode", "mode_for_routing",
    "allreduce_direct", "allreduce_hierarchical", "grad_allreduce",
    "alltoall_direct", "alltoall_hierarchical",
    "AppAwareSelector", "ICICostModel", "TraceCounterBackend",
]

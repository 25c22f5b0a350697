"""The Dragonfly network substrate of the port: topology family,
routing, traffic patterns and the flow-level simulator whose phase
pipeline runs on a torch device (``repro.dragonfly`` is the
reference)."""

from repro_torch.dragonfly.routing import RoutingPolicy
from repro_torch.dragonfly.simulator import (DragonflySimulator, FlowResult,
                                             PhasePlan, SimParams,
                                             TenantSegments)
from repro_torch.dragonfly.topology import (Allocation, DragonflyTopology,
                                            Topology, TopologyParams,
                                            make_allocation, make_topology,
                                            registered_topologies,
                                            small_topology)
from repro_torch.dragonfly.traffic import (PATTERN_KIND, PATTERNS,
                                           allreduce, alltoall, barrier,
                                           broadcast, engine_for_arm, halo3d,
                                           moe_alltoall, pingpong,
                                           run_benchmark, run_iteration,
                                           run_iteration_app_aware,
                                           run_iteration_engine, sweep3d)

__all__ = [
    "DragonflyTopology", "Topology", "TopologyParams", "Allocation",
    "make_allocation", "make_topology", "registered_topologies",
    "small_topology",
    "RoutingPolicy",
    "DragonflySimulator", "SimParams", "FlowResult", "PhasePlan",
    "TenantSegments",
    "pingpong", "allreduce", "alltoall", "barrier", "broadcast", "halo3d",
    "sweep3d", "moe_alltoall", "PATTERNS", "PATTERN_KIND", "run_iteration",
    "run_iteration_engine", "run_iteration_app_aware", "engine_for_arm",
    "run_benchmark",
]

"""The port's copy of ``repro.faults.spec``: declarative, phase-indexed
fault schedules bound to a topology.  The heartbeat detection front end
(``repro.faults.detection``) is not ported yet."""

from repro_torch.faults.spec import (BoundFaultSchedule, FaultSchedule,
                                     FaultSpec, FaultState, counter_dropout,
                                     link_degrade, link_down, link_flap,
                                     random_links, random_routers,
                                     router_down)

__all__ = [
    "FaultSpec", "FaultSchedule", "BoundFaultSchedule", "FaultState",
    "link_down", "link_degrade", "router_down", "link_flap",
    "counter_dropout", "random_links", "random_routers",
]

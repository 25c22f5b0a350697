"""The port's copy of ``repro.faults``: declarative, phase-indexed
fault schedules bound to a topology (``faults/spec.py``), and the
heartbeat-driven detection front end over ``runtime.fault_tolerance``
(``faults/detection.py``)."""

from repro_torch.faults.detection import (DetectionReport, HeartbeatDriver,
                                          remap_allocation)
from repro_torch.faults.spec import (BoundFaultSchedule, FaultSchedule,
                                     FaultSpec, FaultState, counter_dropout,
                                     link_degrade, link_down, link_flap,
                                     random_links, random_routers,
                                     router_down)

__all__ = [
    "FaultSpec", "FaultSchedule", "BoundFaultSchedule", "FaultState",
    "link_down", "link_degrade", "router_down", "link_flap",
    "counter_dropout", "random_links", "random_routers",
    "HeartbeatDriver", "DetectionReport", "remap_allocation",
]

"""The port's copies of the NumPy-only ``repro.core`` modules that the
simulator needs (routing modes, the Eq. (1)/(2) model, NIC counters)."""

from repro_torch.core.counters import CounterBackend, CounterWindow, NICCounters
from repro_torch.core.perf_model import (AriesNICModel, MessageShape,
                                         flits_and_packets,
                                         predict_transmission_cycles)
from repro_torch.core.strategies import ADAPTIVE_MODES, ARIES_MODES, RoutingMode

__all__ = [
    "RoutingMode", "ARIES_MODES", "ADAPTIVE_MODES",
    "AriesNICModel", "MessageShape", "predict_transmission_cycles",
    "flits_and_packets",
    "NICCounters", "CounterWindow", "CounterBackend",
]

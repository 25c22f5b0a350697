"""Routing modes — §2.2 of the paper.

On Cray Aries the user-selectable routing modes (MPICH_GNI_ROUTING_MODE) are
a restricted set of UGAL bias levels plus deterministic modes.  We model the
same enumeration; the Dragonfly simulator interprets the bias, and the TPU
collective layer maps each mode to a collective schedule (see
repro.collectives.modes for the mapping table in DESIGN.md §2).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class RoutingMode(enum.Enum):
    """Aries routing modes (paper §2.2)."""

    #: ADAPTIVE_0 — UGAL with no bias toward minimal paths ("ADAPTIVE").
    ADAPTIVE_0 = "ADAPTIVE_0"
    #: ADAPTIVE_1 — bias toward minimal increases as the packet approaches the
    #: destination ("INCREASINGLY MINIMAL BIAS"); Aries default for alltoall.
    ADAPTIVE_1 = "ADAPTIVE_1"
    #: ADAPTIVE_2 — low constant bias toward minimal.
    ADAPTIVE_2 = "ADAPTIVE_2"
    #: ADAPTIVE_3 — high constant bias toward minimal ("ADAPTIVE HIGH BIAS").
    ADAPTIVE_3 = "ADAPTIVE_3"
    #: Deterministic minimal, path picked by header hash.
    MIN_HASH = "MIN_HASH"
    #: Deterministic non-minimal, path picked by header hash.
    NMIN_HASH = "NMIN_HASH"
    #: Deterministic minimal, in-order delivery.
    IN_ORDER = "IN_ORDER"

    @property
    def is_adaptive(self) -> bool:
        return self in ADAPTIVE_MODES

    @property
    def minimal_bias(self) -> float:
        """Constant additive bias applied to the *non-minimal* congestion
        estimate, in units of mean queue depth.  The exact Aries values are
        not public (paper §2.2); these are the calibration defaults used by
        the simulator and exposed for sensitivity sweeps."""
        return _DEFAULT_BIAS[self]


# Aliases used throughout the paper's prose.
ADAPTIVE = RoutingMode.ADAPTIVE_0
INCREASINGLY_MINIMAL_BIAS = RoutingMode.ADAPTIVE_1
LOW_BIAS = RoutingMode.ADAPTIVE_2
HIGH_BIAS = RoutingMode.ADAPTIVE_3

ARIES_MODES = tuple(RoutingMode)
ADAPTIVE_MODES = (
    RoutingMode.ADAPTIVE_0,
    RoutingMode.ADAPTIVE_1,
    RoutingMode.ADAPTIVE_2,
    RoutingMode.ADAPTIVE_3,
)

# Bias defaults (in mean-queue-depth units). ADAPTIVE_1's bias is hop-
# dependent; the value here is its *terminal* bias (at the last hop), the
# simulator interpolates 0 -> terminal along the path (Bataineh et al. 2017).
_DEFAULT_BIAS = {
    RoutingMode.ADAPTIVE_0: 0.0,
    RoutingMode.ADAPTIVE_1: 6.0,
    RoutingMode.ADAPTIVE_2: 2.0,
    RoutingMode.ADAPTIVE_3: 8.0,
    RoutingMode.MIN_HASH: float("inf"),
    RoutingMode.NMIN_HASH: float("-inf"),
    RoutingMode.IN_ORDER: float("inf"),
}


@dataclass(frozen=True)
class ModePerformance:
    """Per-mode observed telemetry: the (L, s) pair of the paper.

    latency_cycles: request->response packet latency L in NIC cycles.
    stall_cycles_per_flit: mean stall cycles s a ready flit waits.
    age: number of selector invocations since this sample was taken
         (Algorithm 1 discards samples that are "too old").
    """

    latency_cycles: float
    stall_cycles_per_flit: float
    age: int = 0

    def aged(self) -> "ModePerformance":
        return ModePerformance(
            self.latency_cycles, self.stall_cycles_per_flit, self.age + 1
        )

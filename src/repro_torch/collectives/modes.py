"""Collective schedule modes — the TPU analogue of Aries routing modes."""

from __future__ import annotations

import enum

from repro_torch.core.strategies import RoutingMode


class CollectiveMode(enum.Enum):
    #: one-phase flat collective over all participating axes (minimal:
    #: fewest phases, lowest latency; slow pod-boundary links carry the
    #: full ring share)
    DIRECT = "direct"
    #: pod-aware multi-phase schedule (non-minimal: more hops, but the
    #: cross-pod links carry only the per-chip shard)
    HIERARCHICAL = "hierarchical"


#: Aries mode -> schedule, per the DESIGN.md §2 mapping table.
_ROUTING_TO_MODE = {
    RoutingMode.ADAPTIVE_0: CollectiveMode.HIERARCHICAL,
    RoutingMode.ADAPTIVE_1: CollectiveMode.HIERARCHICAL,
    RoutingMode.ADAPTIVE_2: CollectiveMode.DIRECT,
    RoutingMode.ADAPTIVE_3: CollectiveMode.DIRECT,
    RoutingMode.MIN_HASH: CollectiveMode.DIRECT,
    RoutingMode.IN_ORDER: CollectiveMode.DIRECT,
    RoutingMode.NMIN_HASH: CollectiveMode.HIERARCHICAL,
}


def mode_for_routing(mode: RoutingMode) -> CollectiveMode:
    return _ROUTING_TO_MODE[mode]

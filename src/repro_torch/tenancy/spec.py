"""Tenant and job-mix specifications.

A `Workload` is one co-running job's recipe: traffic pattern, scale,
placement tier and routing arm.  A `TenancyMix` is K of them sharing one
physical Dragonfly; `materialize()` turns the recipe into K node-DISJOINT
Allocations (co-tenants contend on links and global channels, never on
NICs — the paper's production setting, where the scheduler hands every
job its own nodes but the network is shared).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly.topology import Allocation, Topology, make_allocation
from repro_torch.dragonfly.traffic import PATTERNS


@dataclass(frozen=True)
class Workload:
    """One tenant job: what it sends, where it sits, how it routes.

    arm: a RoutingMode member (static routing, broadcast over the
    tenant's flows) or a repro_torch.policy name ("app_aware" | "eps_greedy" |
    "static") — named arms get a PolicyEngine deciding per phase.
    """

    name: str
    pattern: str                          # repro_torch.dragonfly.traffic.PATTERNS
    n_ranks: int
    pattern_args: Mapping = field(default_factory=dict)
    arm: object = RoutingMode.ADAPTIVE_0
    spread: str = "scattered"             # make_allocation placement tier

    def __post_init__(self):
        if self.pattern not in PATTERNS:
            raise ValueError(f"unknown pattern {self.pattern!r}; expected "
                             f"one of {sorted(PATTERNS)}")

    @property
    def is_engine_arm(self) -> bool:
        """True when `arm` names a repro_torch.policy PolicyEngine."""
        return isinstance(self.arm, str)

    def phases(self):
        """The job's per-iteration phase list [(src, dst, bytes), ...]."""
        return PATTERNS[self.pattern](self.n_ranks, **dict(self.pattern_args))

    def with_arm(self, arm) -> "Workload":
        return dataclasses.replace(self, arm=arm)

    def with_spread(self, spread: str) -> "Workload":
        return dataclasses.replace(self, spread=spread)


@dataclass(frozen=True)
class TenancyMix:
    """K workloads co-scheduled on one machine; workloads[victim] is the
    job whose slowdown the interference matrix reports (the rest are the
    aggressors)."""

    name: str
    workloads: tuple
    victim: int = 0
    #: optional topology spec for this mix (make_topology string); None
    #: means the engine/sweep caller's machine.  docs/topology.md.
    topology: str | None = None

    def __post_init__(self):
        if not self.workloads:
            raise ValueError("a TenancyMix needs at least one workload")
        if not 0 <= self.victim < len(self.workloads):
            raise ValueError(f"victim index {self.victim} out of range")
        names = [w.name for w in self.workloads]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate workload names in {names}")

    def __len__(self) -> int:
        return len(self.workloads)

    @property
    def victim_workload(self) -> Workload:
        return self.workloads[self.victim]

    def with_victim_arm(self, arm) -> "TenancyMix":
        """The sweep's policy axis: swap the victim's routing arm."""
        ws = list(self.workloads)
        ws[self.victim] = ws[self.victim].with_arm(arm)
        return dataclasses.replace(self, workloads=tuple(ws))

    def with_victim_spread(self, spread: str) -> "TenancyMix":
        """The sweep's placement axis: re-place the victim."""
        ws = list(self.workloads)
        ws[self.victim] = ws[self.victim].with_spread(spread)
        return dataclasses.replace(self, workloads=tuple(ws))

    def materialize(self, topo: Topology, *,
                    seed: int = 0, max_tries: int = 64) -> list:
        """Draw node-DISJOINT allocations, one per workload.

        Deterministic in (mix, topo, seed): each tenant retries its
        placement seed until it avoids every earlier tenant's nodes, so
        the same mix on the same machine always lands the same way —
        run-alone baselines reuse these exact allocations.
        """
        allocs: list = []
        used: set = set()
        for i, w in enumerate(self.workloads):
            if w.spread == "scattered":
                # dense mixes: draw straight from the unused-node pool
                # (independent redraws would collide almost surely)
                pool = np.asarray(sorted(set(range(topo.n_nodes))
                                         - used), dtype=np.int64)
                if pool.size < w.n_ranks:
                    raise RuntimeError(
                        f"cannot place {w.name!r}: {w.n_ranks} ranks but "
                        f"only {pool.size} free nodes")
                rng = np.random.default_rng(seed + 1009 * i)
                a = Allocation(
                    allocation_id=f"{self.name}/{w.name}",
                    nodes=tuple(int(x) for x in
                                rng.choice(pool, size=w.n_ranks,
                                           replace=False)))
            else:
                for attempt in range(max_tries):
                    a = make_allocation(
                        topo, w.n_ranks, spread=w.spread,
                        seed=seed + 1009 * i + attempt,
                        allocation_id=f"{self.name}/{w.name}")
                    if used.isdisjoint(a.nodes):
                        break
                else:
                    raise RuntimeError(
                        f"could not place {w.name!r} disjointly after "
                        f"{max_tries} tries (machine too small for the "
                        f"mix?)")
            used.update(a.nodes)
            allocs.append(a)
        return allocs

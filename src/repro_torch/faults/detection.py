"""Fault detection front end: heartbeats driven by the fault schedule.

``runtime.fault_tolerance`` ships a phi-accrual :class:`HeartbeatMonitor`
and a :class:`RestartPolicy` that were tested but wired to nothing.
This module closes the loop against :mod:`repro_torch.faults.spec`:

  * :class:`HeartbeatDriver` ticks the monitor once per phase —
    ``router_down`` (and dead NIC links) *suppress* the affected nodes'
    heartbeats, so after enough silent phases phi-accrual flags them
    DEAD without any oracle channel from the injector to the detector;
  * when the restart policy answers ``ELASTIC_SHRINK``, the allocation
    is re-materialised from the unused-node pool
    (:func:`remap_allocation`): dead ranks move to healthy free nodes,
    and only when the pool runs dry does the job truly shrink.

Everything is deterministic given the schedule and seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.dragonfly.topology import Allocation
from repro_torch.faults.spec import BoundFaultSchedule
from repro_torch.runtime.fault_tolerance import (FaultToleranceConfig,
                                           HeartbeatMonitor, RestartAction,
                                           RestartPolicy)


def remap_allocation(topo, allocation: Allocation, dead_nodes, *,
                     down_nodes=(), used_nodes=(), seed: int = 0,
                     tag: str = "remap") -> Allocation:
    """Re-materialise ``allocation`` with its dead ranks moved onto
    healthy nodes from the unused pool.

    The pool is every machine node minus the allocation itself, minus
    ``used_nodes`` (other tenants), minus ``down_nodes`` (nodes the
    fault schedule currently makes unreachable — replacements must not
    land on a dead router).  Replacement nodes are drawn seeded; when
    the pool is smaller than the number of dead ranks the remainder is
    dropped (a true elastic shrink).  Rank order of surviving nodes is
    preserved.
    """
    dead = set(int(n) for n in dead_nodes)
    if not dead:
        return allocation
    blocked = set(int(n) for n in allocation.nodes)
    blocked |= set(int(n) for n in used_nodes)
    blocked |= set(int(n) for n in down_nodes)
    pool = np.setdiff1d(np.arange(topo.n_nodes, dtype=np.int64),
                        np.asarray(sorted(blocked), dtype=np.int64))
    rng = np.random.default_rng(seed)
    take = min(len(dead), int(pool.size))
    repl = list(rng.choice(pool, size=take, replace=False)) if take else []
    nodes = []
    for n in allocation.nodes:
        if int(n) in dead:
            if repl:
                nodes.append(int(repl.pop(0)))
            # else: pool exhausted — drop the rank (shrink)
        else:
            nodes.append(int(n))
    return Allocation(
        allocation_id=f"{allocation.allocation_id}@{tag}",
        nodes=tuple(nodes))


@dataclass
class DetectionReport:
    """One ``poll`` outcome: what died, what the policy decided, and the
    (possibly re-materialised) allocation going forward."""

    phase: int
    dead_nodes: tuple
    action: RestartAction
    allocation: Allocation


class HeartbeatDriver:
    """Drives phi-accrual detection from the bound fault schedule.

    One driver watches one allocation.  Call :meth:`tick` once per
    phase: healthy nodes heartbeat, nodes silenced by the schedule
    (down router / dead NIC link) do not.  :meth:`poll` asks the
    monitor for dead nodes and turns the restart policy's answer into a
    concrete allocation — ``RESTART_IN_PLACE`` keeps the node set
    (spare swaps in on the same slot), ``ELASTIC_SHRINK``
    re-materialises via :func:`remap_allocation`.
    """

    def __init__(self, bound: BoundFaultSchedule, allocation: Allocation,
                 cfg: FaultToleranceConfig | None = None, *,
                 spares: int = 0, phase_duration_s: float | None = None,
                 seed: int = 0):
        self.bound = bound
        self.topo = bound.topo
        self.allocation = allocation
        self.cfg = cfg or FaultToleranceConfig()
        # default cadence: one heartbeat per phase
        self.phase_duration_s = (phase_duration_s
                                 if phase_duration_s is not None
                                 else self.cfg.heartbeat_interval_s)
        self.monitor = HeartbeatMonitor(allocation.nodes, self.cfg,
                                        now_s=0.0)
        self.restart = RestartPolicy(self.cfg, spares_available=spares)
        self.seed = seed
        self.now_s = 0.0
        self._remaps = 0

    def tick(self, phase: int) -> tuple:
        """Advance one phase: every reachable node heartbeats, nodes the
        schedule silences stay quiet.  Returns the silenced node ids."""
        self.now_s += self.phase_duration_s
        down = set(int(n) for n in self.bound.down_nodes_at(phase))
        for node in self.allocation.nodes:
            if int(node) not in down:
                self.monitor.heartbeat(node, self.now_s)
        return tuple(sorted(down & set(int(n)
                                       for n in self.allocation.nodes)))

    def poll(self, phase: int, *, used_nodes=()) -> DetectionReport:
        """Detect, decide, and (for ELASTIC_SHRINK) re-materialise."""
        dead = [n for n in self.monitor.dead_nodes(self.now_s)
                if n in self.allocation.nodes]
        action = self.restart.on_failure(dead, self.now_s)
        alloc = self.allocation
        if action == RestartAction.ELASTIC_SHRINK:
            self._remaps += 1
            alloc = remap_allocation(
                self.topo, alloc, dead,
                down_nodes=self.bound.down_nodes_at(phase),
                used_nodes=used_nodes,
                seed=self.seed + self._remaps,
                tag=f"remap{self._remaps}")
            self.allocation = alloc
            # fresh slate for the re-materialised node set
            self.monitor = HeartbeatMonitor(alloc.nodes, self.cfg,
                                            now_s=self.now_s)
        return DetectionReport(phase=phase, dead_nodes=tuple(dead),
                               action=action, allocation=alloc)

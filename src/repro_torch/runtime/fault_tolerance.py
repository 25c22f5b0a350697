"""Failure detection + restart policy.

At 1000+ nodes, MTBF is minutes-to-hours; the control plane must (a) detect
dead workers fast without false-positives from GC/compile pauses, (b)
decide restart-in-place vs elastic-shrink, (c) resume step-exact from the
last checkpoint.  HeartbeatMonitor implements phi-accrual-style detection
(suspicion grows with silence relative to observed inter-arrival jitter);
RestartPolicy turns failure events into actions."""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field


class NodeState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclass(frozen=True)
class FaultToleranceConfig:
    heartbeat_interval_s: float = 5.0
    suspect_phi: float = 3.0       # suspicion threshold (std devs)
    dead_phi: float = 8.0
    min_std_s: float = 0.5         # jitter floor (compile pauses)
    max_restarts_per_hour: int = 6


@dataclass
class _NodeStats:
    last_seen: float = 0.0
    mean_gap: float = 5.0
    var_gap: float = 1.0
    n: int = 0


class HeartbeatMonitor:
    """phi-accrual failure detector over worker heartbeats."""

    def __init__(self, node_ids, cfg: FaultToleranceConfig, now_s: float = 0.0):
        self.cfg = cfg
        self.stats = {n: _NodeStats(last_seen=now_s) for n in node_ids}

    def heartbeat(self, node_id, now_s: float) -> None:
        st = self.stats[node_id]
        if st.n > 0:
            gap = now_s - st.last_seen
            alpha = 0.2
            delta = gap - st.mean_gap
            st.mean_gap += alpha * delta
            st.var_gap = (1 - alpha) * (st.var_gap + alpha * delta * delta)
        st.last_seen = now_s
        st.n += 1

    def phi(self, node_id, now_s: float) -> float:
        st = self.stats[node_id]
        silence = now_s - st.last_seen
        std = max(math.sqrt(st.var_gap), self.cfg.min_std_s)
        return max(0.0, (silence - st.mean_gap) / std)

    def state(self, node_id, now_s: float) -> NodeState:
        p = self.phi(node_id, now_s)
        if p >= self.cfg.dead_phi:
            return NodeState.DEAD
        if p >= self.cfg.suspect_phi:
            return NodeState.SUSPECT
        return NodeState.HEALTHY

    def dead_nodes(self, now_s: float) -> list:
        return [n for n in self.stats
                if self.state(n, now_s) == NodeState.DEAD]


class RestartAction(enum.Enum):
    NONE = "none"
    RESTART_IN_PLACE = "restart_in_place"   # spare available
    ELASTIC_SHRINK = "elastic_shrink"       # drop the pod, reshard
    ABORT = "abort"                         # restart budget exhausted


@dataclass
class RestartPolicy:
    cfg: FaultToleranceConfig
    spares_available: int = 0
    restart_times: list = field(default_factory=list)

    def on_failure(self, dead_nodes: list, now_s: float) -> RestartAction:
        if not dead_nodes:
            return RestartAction.NONE
        self.restart_times = [t for t in self.restart_times
                              if now_s - t < 3600.0]
        if len(self.restart_times) >= self.cfg.max_restarts_per_hour:
            return RestartAction.ABORT
        self.restart_times.append(now_s)
        if self.spares_available >= len(dead_nodes):
            self.spares_available -= len(dead_nodes)
            return RestartAction.RESTART_IN_PLACE
        return RestartAction.ELASTIC_SHRINK

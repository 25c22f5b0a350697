"""PolicyEngine — the single entry point for mode selection everywhere.

One engine call per simulator step / benchmark batch:

    engine = PolicyEngine(AppAwarePolicy(AppAwareConfig()))
    modes = engine.decide(DecisionBatch.of(bytes_array, site="a2a",
                                           kind=KIND_ALLTOALL))
    ... send ...
    engine.bus.publish_flow_arrays(latency_us, stalls_per_flit)  # -> update

The engine owns: the Policy, the TelemetryBus (subscribed so published
feedback flows straight into Policy.update for the last-decided batch),
and a TrafficLedger for Fig. 8/9-style traffic-fraction reporting.
"""

from __future__ import annotations

from typing import Hashable

import numpy as np

from repro_torch.core.strategies import RoutingMode
from repro_torch.policy.app_aware import AppAwareConfig, AppAwarePolicy
from repro_torch.policy.notification import NotificationConfig, NotificationPolicy
from repro_torch.policy.policies import EpsilonGreedyPolicy, StaticPolicy
from repro_torch.policy.telemetry import TelemetryBus
from repro_torch.policy.types import (DecisionBatch, Feedback, Policy,
                                TrafficLedger)

POLICY_NAMES = ("static", "app_aware", "eps_greedy", "notification")


class PolicyEngine:
    """Vectorized decision front-end over a pluggable Policy.

    Bounded-staleness guard (docs/faults.md): an adaptive policy steered
    by telemetry that stopped arriving (NIC-counter dropout, a crashed
    collector) is worse than no policy — it keeps acting on a frozen,
    possibly fault-contaminated estimate.  With ``staleness_limit=k``
    the engine counts decide() calls since the last feedback delivery;
    at >= k it stops consulting the policy and emits ``fallback_mode``
    (default minimal / ADAPTIVE_3, the paper's safe static arm) until
    telemetry resumes, which instantly restores the policy path.
    ``staleness_limit=None`` (default) disables the guard.
    """

    def __init__(self, policy: Policy, bus: TelemetryBus | None = None, *,
                 staleness_limit: int | None = None,
                 fallback_mode=None):
        self.policy = policy
        self.bus = bus if bus is not None else TelemetryBus()
        self.bus.subscribe(self._on_feedback)
        self.ledger = TrafficLedger()
        self.decide_calls = 0
        self.rows_decided = 0
        self._last_batch: DecisionBatch | None = None
        self.last_modes: np.ndarray | None = None
        self.staleness_limit = staleness_limit
        self.fallback_mode = (fallback_mode if fallback_mode is not None
                              else RoutingMode.ADAPTIVE_3)
        self.decides_since_feedback = 0
        self.fallback_decides = 0

    @property
    def degraded(self) -> bool:
        """True while the staleness guard forces fallback decisions."""
        return (self.staleness_limit is not None
                and self.decides_since_feedback >= self.staleness_limit)

    # ----------------------------------------------------------------- decide
    def decide(self, batch: DecisionBatch) -> np.ndarray:
        """One call, [n] decisions.  Returns an object array of modes."""
        if self.degraded:
            # stale telemetry: bypass the policy, emit the static
            # fallback arm (policy state stays frozen, not contaminated)
            modes = np.full(len(batch), self.fallback_mode, dtype=object)
            self.fallback_decides += 1
            gated = None
        else:
            modes = self.policy.decide(batch)
            self.decides_since_feedback += 1
            gated = getattr(self.policy, "last_gated", None)
        self.ledger.add_batch(modes, batch.msg_bytes, gated=gated)
        self.decide_calls += 1
        self.rows_decided += len(batch)
        self._last_batch = batch
        self.last_modes = modes
        return modes

    def decide_bytes(self, msg_bytes, *, site: Hashable = "default",
                     kind: str = "pt2pt") -> np.ndarray:
        """Convenience: build the batch and decide in one call."""
        return self.decide(DecisionBatch.of(msg_bytes, site, kind))

    # ----------------------------------------------------------------- update
    def update(self, feedback: Feedback,
               batch: DecisionBatch | None = None) -> None:
        """Feed telemetry back for `batch` (default: the last decide())."""
        b = batch if batch is not None else self._last_batch
        if b is None:
            return
        if len(feedback) == 1 and len(b) > 1:
            # one aggregate sample for the whole batch (counter-window
            # reads): broadcast it over the rows — the notification
            # signal rides along, None stays None (no signal != calm)
            feedback = Feedback.of(
                np.full(len(b), float(feedback.latency_cycles[0])),
                np.full(len(b), float(feedback.stalls_per_flit[0])),
                source=feedback.source,
                notified=None if feedback.notified is None
                else np.full(len(b), float(feedback.notified[0])))
        self.policy.update(b, feedback)

    def _on_feedback(self, feedback: Feedback) -> None:
        # telemetry arrived: the staleness clock restarts (recovering
        # from a degraded stretch the moment counters resume)
        self.decides_since_feedback = 0
        self.update(feedback)

    # ------------------------------------------------------------------ faults
    def on_fault_epoch(self, site_filter=None) -> int:
        """Fault-epoch notification (docs/faults.md): the machine's link
        set changed, so latency/stall samples gathered before the epoch
        no longer describe the paths being scored.  Forwards to the
        policy's ``reset_samples`` (AppAware/EpsilonGreedy; static
        policies have no state) for the sites matching ``site_filter``
        (None = all).  Returns the number of sites reset."""
        reset = getattr(self.policy, "reset_samples", None)
        return reset(site_filter) if reset is not None else 0

    # ------------------------------------------------------------------ stats
    def traffic_fraction(self, mode: Hashable, *,
                         include_gated: bool = True) -> float:
        return self.ledger.traffic_fraction(mode,
                                            include_gated=include_gated)

    def gated_fraction(self) -> float:
        return self.ledger.gated_fraction()


def make_engine(name: str, *,
                mode_a: Hashable = RoutingMode.ADAPTIVE_0,
                mode_b: Hashable = RoutingMode.ADAPTIVE_3,
                mode_a_alltoall: Hashable = None,
                config: AppAwareConfig | None = None,
                granularity: str = "phase",
                epsilon: float = 0.1,
                epsilon_decay: float = 0.15,
                static_mode: Hashable = None,
                seed: int = 0,
                bus: TelemetryBus | None = None,
                staleness_limit: int | None = None,
                fallback_mode: Hashable = None) -> PolicyEngine:
    """Factory mapping CLI names to engines.

    "static"       -> StaticPolicy(static_mode or mode_a)
    "app_aware"    -> AppAwarePolicy (Algorithm 1)
    "eps_greedy"   -> EpsilonGreedyPolicy over (mode_a, mode_b)
    "notification" -> NotificationPolicy: calm regime = mode_b (the
                      minimal arm), congested regime = mode_a (the
                      spreading arm), switched by the congestion-
                      notification signal (docs/policy_api.md)

    ``staleness_limit``/``fallback_mode`` arm the engine's bounded-
    staleness guard (docs/faults.md).
    """
    if mode_a_alltoall is None:
        # default-arm case: alltoall sites use INCR-MINIMAL (paper §4.2),
        # for app_aware AND eps_greedy alike, so the bandit arbitrates the
        # same two arms Algorithm 1 does; custom arms keep mode_a
        mode_a_alltoall = (AppAwareConfig.mode_a_alltoall
                          if mode_a is RoutingMode.ADAPTIVE_0 else mode_a)
    if name == "static":
        policy: Policy = StaticPolicy(
            static_mode if static_mode is not None else mode_a)
    elif name == "app_aware":
        cfg = config or AppAwareConfig(
            mode_a=mode_a, mode_b=mode_b,
            mode_a_alltoall=mode_a_alltoall)
        policy = AppAwarePolicy(cfg, granularity=granularity)
    elif name == "eps_greedy":
        policy = EpsilonGreedyPolicy(
            mode_a=mode_a, mode_b=mode_b,
            mode_a_alltoall=mode_a_alltoall, epsilon=epsilon,
            epsilon_decay=epsilon_decay, seed=seed)
    elif name == "notification":
        policy = NotificationPolicy(NotificationConfig(
            mode_calm=mode_b, mode_congested=mode_a))
    else:
        raise ValueError(
            f"unknown policy {name!r}; expected one of {POLICY_NAMES}")
    return PolicyEngine(policy, bus=bus, staleness_limit=staleness_limit,
                        fallback_mode=fallback_mode)

"""TelemetryBus — one feedback pipe for every counter source.

The paper's Algorithm 1 consumes a single (L, s) pair per observation;
the repo has three producers of that pair with three different units:

  * Aries NIC counters (`core/counters.py`): CounterDelta with
    mean_latency_us and stalls_per_flit — the faithful hardware path;
  * HLO counters (`collectives/hlo_counters.py`): the same NICCounters
    synthesized from a compiled XLA module, read through CounterWindow;
  * the Dragonfly simulator: per-flow latency_us / stalls_per_flit
    arrays straight out of the fluid model (FlowResult).

The bus normalizes all of them into `Feedback` records (latency in NIC
cycles, stalls per flit) and fans them out to subscribers — typically a
PolicyEngine, which forwards them to its Policy.  Publishing never
blocks or reorders: counters are read *after* the send, so policies stay
strictly one message behind, as in the paper (§4.3).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, List

import numpy as np

from repro_torch.core.counters import CounterDelta, CounterWindow
from repro_torch.core.perf_model import NIC_CLOCK_GHZ
from repro_torch.core.strategies import ModePerformance
from repro_torch.policy.types import Feedback


def us_to_cycles(latency_us, clock_ghz: float = NIC_CLOCK_GHZ):
    return np.asarray(latency_us, dtype=np.float64) * clock_ghz * 1e3


#: canonical counter kinds the bus accepts as Feedback.source.  "notify"
#: is the congestion-notification channel (SimParams.notify_* +
#: NotificationPolicy): producers that only carry notification exposure
#: tag their feedback with it so subscribers can tell the signal apart
#: from ordinary (L, s) telemetry.
COUNTER_KINDS = ("nic", "hlo", "sim", "model", "notify")

#: accepted aliases -> canonical kind (every canonical kind maps to
#: itself implicitly, which is what makes normalize_kind idempotent)
_KIND_ALIASES = {
    "nics": "nic", "counter": "nic", "counters": "nic", "aries": "nic",
    "xla": "hlo", "simulator": "sim", "flows": "sim",
    "cost_model": "model", "notification": "notify",
    "notifications": "notify", "cn": "notify",
}


def normalize_kind(kind: str) -> str:
    """Canonicalize a counter-kind label.

    Case/whitespace-insensitive alias resolution into COUNTER_KINDS.
    Idempotent by construction — ``normalize_kind(normalize_kind(k)) ==
    normalize_kind(k)`` for every accepted input (property-tested in
    tests/test_telemetry_props.py).  Unknown kinds raise ValueError so a
    typoed provenance tag fails loudly instead of silently forking the
    telemetry namespace.
    """
    k = str(kind).strip().lower()
    k = _KIND_ALIASES.get(k, k)
    if k not in COUNTER_KINDS:
        raise ValueError(f"unknown counter kind {kind!r}; expected one "
                         f"of {COUNTER_KINDS} or an alias "
                         f"{tuple(_KIND_ALIASES)}")
    return k


@dataclass
class TelemetryBus:
    """Normalize heterogeneous counters into Feedback and fan out."""

    clock_ghz: float = NIC_CLOCK_GHZ
    _subscribers: List[Callable[[Feedback], None]] = field(
        default_factory=list)
    #: ring of recent feedback, handy for debugging/benchmark reporting
    history: list = field(default_factory=list)
    history_limit: int = 64

    # ----------------------------------------------------------- pub/sub
    def subscribe(self, callback: Callable[[Feedback], None]) -> None:
        self._subscribers.append(callback)

    def publish(self, feedback: Feedback) -> None:
        # the bus owns the counter-kind namespace: whatever alias the
        # producer used, subscribers always see the canonical kind
        src = normalize_kind(feedback.source)
        if src != feedback.source:
            feedback = replace(feedback, source=src)
        self.history.append(feedback)
        if len(self.history) > self.history_limit:
            del self.history[: len(self.history) - self.history_limit]
        for cb in self._subscribers:
            cb(feedback)

    # ------------------------------------------------------- normalizers
    def from_counter_delta(self, delta: CounterDelta, *,
                           source: str = "nic") -> Feedback:
        """Aries/HLO NIC counters -> one aggregate (L, s) sample (plus
        the window's notified fraction when the NIC saw notification
        events — zero-notification windows still carry the 0.0 signal,
        which is how reactive policies learn the congestion cleared)."""
        return Feedback.of(
            us_to_cycles(delta.mean_latency_us, self.clock_ghz),
            [delta.stalls_per_flit],
            weight=[max(float(delta.flits), 1.0)],
            source=source,
            notified=[delta.notified_fraction])

    def from_counter_window(self, window: CounterWindow, *,
                            source: str = "nic") -> Feedback:
        """Read a CounterWindow delta and normalize it (§3.2-safe)."""
        return self.from_counter_delta(window.read(), source=source)

    def from_flow_arrays(self, latency_us, stalls_per_flit, *,
                         weight=None, source: str = "sim",
                         notified=None) -> Feedback:
        """Dragonfly FlowResult observables -> per-flow Feedback rows.

        ``notified`` (optional, [n] in [0, 1]) is FlowResult.notified —
        the per-flow congestion-notification exposure.  Leave it None
        when the simulator's channel is disabled; passing an array keeps
        source semantics intact (the rows still carry (L, s)), it just
        adds the notification signal alongside."""
        return Feedback.of(
            us_to_cycles(latency_us, self.clock_ghz), stalls_per_flit,
            weight=weight, source=source, notified=notified)

    def from_mode_performance(self, perf: ModePerformance, *,
                              source: str = "model") -> Feedback:
        """Cost-model prediction -> one sample (dry-run self-feeding)."""
        return Feedback.single(perf.latency_cycles,
                               perf.stall_cycles_per_flit, source=source)

    # ------------------------------------------------ publish shorthands
    def publish_counter_delta(self, delta: CounterDelta, *,
                              source: str = "nic") -> Feedback:
        fb = self.from_counter_delta(delta, source=source)
        self.publish(fb)
        return fb

    def publish_flow_arrays(self, latency_us, stalls_per_flit, *,
                            weight=None, source: str = "sim",
                            notified=None) -> Feedback:
        fb = self.from_flow_arrays(latency_us, stalls_per_flit,
                                   weight=weight, source=source,
                                   notified=notified)
        self.publish(fb)
        return fb

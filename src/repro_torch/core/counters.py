"""NIC network-counter abstraction — paper §2.3.

The paper relies *only* on NIC-side counters (request flits, stalled cycles,
request packets, cumulative latency) because (a) users cannot see network
tiles outside their job and (b) tile counters mix traffic from other jobs
(§3.2).  We model exactly those four counters and the derived (L, s) pair.

Backends:
  * the Dragonfly simulator (repro_torch.dragonfly.simulator) increments counters
    as its fluid model moves flits — the faithful reproduction path;
  * the HLO backend (repro.collectives.hlo_counters) synthesizes the same
    counters from a compiled XLA module's collective ops — the TPU dry-run
    path, where "request flits" become bytes-on-wire per link class.

Counters are monotonically increasing, like the hardware; consumers read
deltas through CounterWindow (which also fixes the §3.2 pitfall: deltas are
normalized per observation window, never correlated raw).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol


@dataclass
class NICCounters:
    """The four Aries NIC counters used by the paper (monotonic), plus
    the congestion-notification event counter of the notification
    channel (SimParams.notify_*, docs/policy_api.md) — one event per
    sent message whose bytes crossed a visibly-flagged link.  Like the
    other four it is NIC-side and allocation-scoped: a job only ever
    counts notifications its own traffic received (§3.2)."""

    request_flits: int = 0
    request_flits_stalled_cycles: int = 0
    request_packets: int = 0
    request_packets_cumulative_latency_us: float = 0.0
    congestion_notifications: int = 0

    def observe(self, flits: int, stalled_cycles: int, packets: int,
                latency_us_total: float, notifications: int = 0) -> None:
        self.request_flits += flits
        self.request_flits_stalled_cycles += stalled_cycles
        self.request_packets += packets
        self.request_packets_cumulative_latency_us += latency_us_total
        self.congestion_notifications += notifications

    def snapshot(self) -> "NICCounters":
        return NICCounters(
            self.request_flits,
            self.request_flits_stalled_cycles,
            self.request_packets,
            self.request_packets_cumulative_latency_us,
            self.congestion_notifications,
        )


@dataclass(frozen=True)
class CounterDelta:
    """Counter difference over one observation window, with derived L and s."""

    flits: int
    stalled_cycles: int
    packets: int
    latency_us_total: float
    window_s: float  # wall-clock length of the observation window
    notifications: int = 0  # congestion-notification events in the window

    @property
    def mean_latency_us(self) -> float:
        """L — average request->response latency (us)."""
        return self.latency_us_total / self.packets if self.packets else 0.0

    @property
    def notified_fraction(self) -> float:
        """Fraction of the window's messages that saw a congestion
        notification (the notification channel's per-window signal)."""
        return self.notifications / self.packets if self.packets else 0.0

    @property
    def stalls_per_flit(self) -> float:
        """s — average stall cycles per ready flit."""
        return self.stalled_cycles / self.flits if self.flits else 0.0

    @property
    def flit_rate(self) -> float:
        """Flits per second — the §3.2-safe normalized traffic intensity."""
        return self.flits / self.window_s if self.window_s > 0 else 0.0


class CounterBackend(Protocol):
    """Anything that exposes live NICCounters and a wall clock."""

    def read_counters(self) -> NICCounters: ...
    def now_s(self) -> float: ...


@dataclass
class CounterWindow:
    """Delta reader over a CounterBackend (fixes §3.2: always windowed)."""

    backend: CounterBackend
    _last: NICCounters = field(default_factory=NICCounters)
    _last_t: float = 0.0
    _primed: bool = False

    def read(self) -> CounterDelta:
        cur = self.backend.read_counters()
        now = self.backend.now_s()
        if not self._primed:
            self._last, self._last_t, self._primed = cur.snapshot(), now, True
            return CounterDelta(0, 0, 0, 0.0, 0.0)
        delta = CounterDelta(
            flits=cur.request_flits - self._last.request_flits,
            stalled_cycles=(cur.request_flits_stalled_cycles
                            - self._last.request_flits_stalled_cycles),
            packets=cur.request_packets - self._last.request_packets,
            latency_us_total=(cur.request_packets_cumulative_latency_us
                              - self._last.request_packets_cumulative_latency_us),
            window_s=now - self._last_t,
            notifications=(cur.congestion_notifications
                           - self._last.congestion_notifications),
        )
        self._last, self._last_t = cur.snapshot(), now
        return delta


@dataclass
class InMemoryBackend:
    """Trivial backend for unit tests and for the TPU/HLO adapter, which
    pushes synthesized counter increments into it."""

    counters: NICCounters = field(default_factory=NICCounters)
    clock_s: float = 0.0

    def read_counters(self) -> NICCounters:
        return self.counters

    def now_s(self) -> float:
        return self.clock_s

    def advance(self, dt_s: float) -> None:
        self.clock_s += dt_s

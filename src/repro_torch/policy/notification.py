"""NotificationPolicy — notification-driven adaptive routing.

Rocher-Gonzalez et al. (arXiv:2502.00616) study congestion-management
for Dragonflies built on *explicit notifications*: switches that detect
queue build-up past a threshold notify the sources, which throttle or
re-route until the congestion clears, with a two-level hysteresis so
the signal does not chatter around a single threshold.  That is the
third congestion signal next to this repo's queue-occupancy estimates
(UGAL) and app-aware bias — and this policy is its consumer.

The simulator side (``SimParams.notify_*``, docs/policy_api.md) raises
per-link flags, delays them by the propagation latency, penalizes
flagged links in the routing scores, and reports each flow's *notified
exposure* (fraction of sprayed bytes that crossed a flagged link)
through FlowResult / TelemetryBus / the NIC notification counter.
``NotificationPolicy`` closes the loop at the mode level, per call
site:

  * **calm regime** — no recent notifications: keep the minimal-biased
    arm (``mode_calm``, default HIGH BIAS), the cheap choice while the
    network is quiet;
  * **congested regime** — the site's notified-exposure EMA crossed
    ``on_threshold``: demote minimal paths and emit the spreading arm
    (``mode_congested``, default ADAPTIVE) until the EMA falls back
    below ``off_threshold`` (hysteresis) and the regime has dwelt at
    least ``min_dwell`` updates (no per-phase flip-flopping).

Like every policy in repro_torch.policy it is vectorized (one automaton touch
per (site, kind) group) and carries the ``reset_samples`` fault-epoch
hook: notifications raised on a link set that no longer exists must not
steer the next epoch's decisions (docs/faults.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Hashable

import numpy as np

from repro_torch.core.strategies import RoutingMode
from repro_torch.policy.types import DecisionBatch, Feedback


@dataclass(frozen=True)
class NotificationConfig:
    """Calibration of the notification-reactive automaton."""

    #: calm-regime arm: bias toward minimal paths while nothing notifies
    mode_calm: Hashable = RoutingMode.ADAPTIVE_3
    #: congested-regime arm: spread over non-minimal paths while notified
    mode_congested: Hashable = RoutingMode.ADAPTIVE_0
    #: notified-exposure EMA that trips the congested regime (high water)
    on_threshold: float = 0.05
    #: ... and that clears it again (low water; the hysteresis band keeps
    #: the automaton from chattering around one threshold, 2502.00616)
    off_threshold: float = 0.01
    #: EMA weight of the newest exposure sample
    ema: float = 0.5
    #: minimum feedback updates a regime persists before switching back
    min_dwell: int = 2

    def __post_init__(self):
        if not 0.0 <= self.off_threshold <= self.on_threshold:
            raise ValueError("need 0 <= off_threshold <= on_threshold")


@dataclass
class _SiteNotify:
    """Per-(site) automaton state."""

    ema: float = 0.0
    congested: bool = False
    dwell: int = 0          # updates since the last regime switch
    n: int = 0              # exposure samples folded in


@dataclass
class NotificationPolicy:
    """Threshold + hysteresis regime switching on notification telemetry."""

    config: NotificationConfig = field(default_factory=NotificationConfig)
    _sites: dict = field(default_factory=dict)   # site -> _SiteNotify

    def _state(self, site: Hashable) -> _SiteNotify:
        st = self._sites.get(site)
        if st is None:
            st = self._sites[site] = _SiteNotify()
        return st

    # ------------------------------------------------------------- decide
    def decide(self, batch: DecisionBatch) -> np.ndarray:
        cfg = self.config
        modes = np.empty(len(batch), dtype=object)
        for site, _kind, rows in batch.groups():
            st = self._state(site)
            modes[rows] = cfg.mode_congested if st.congested \
                else cfg.mode_calm
        return modes

    # ------------------------------------------------------------- update
    def update(self, batch: DecisionBatch, feedback: Feedback) -> None:
        """Fold the batch's notified exposure into each site's EMA and
        step the regime automaton.  Feedback without a notification
        signal (``feedback.notified is None`` — the channel is disabled
        or the producer predates it) leaves the state untouched, so the
        policy degrades to a static ``mode_calm`` arm."""
        sig = feedback.notified
        if sig is None:
            return
        cfg = self.config
        w = feedback.weight
        for site, _kind, rows in batch.groups():
            st = self._state(site)
            tot = float(w[rows].sum()) or 1.0
            x = float((sig[rows] * w[rows]).sum() / tot)
            st.ema = x if st.n == 0 else \
                (1.0 - cfg.ema) * st.ema + cfg.ema * x
            st.n += 1
            st.dwell += 1
            if not st.congested and st.ema >= cfg.on_threshold:
                st.congested, st.dwell = True, 0
            elif st.congested and st.ema <= cfg.off_threshold \
                    and st.dwell >= cfg.min_dwell:
                st.congested, st.dwell = False, 0

    # ------------------------------------------------------------- faults
    def reset_samples(self, site_filter=None) -> int:
        """Fault-epoch hook (docs/faults.md): notifications measured on
        the previous link set no longer describe any live path — matching
        sites drop back to the calm regime with a fresh EMA.  Returns the
        number of sites reset."""
        hit = [s for s in self._sites
               if site_filter is None or site_filter(s)]
        for s in hit:
            del self._sites[s]
        return len(hit)

    # -------------------------------------------------------------- stats
    def site_state(self, site: Hashable) -> _SiteNotify | None:
        """Introspection for tests/benchmarks (None = never touched)."""
        return self._sites.get(site)

"""Straggler mitigation.

Per-step worker timings feed a robust deadline (median + k*MAD).  Workers
that repeatedly miss it get flagged; mitigation is (a) data re-balance —
shrink the straggler's shard of the global batch, handing tokens to fast
workers — and (b) eviction recommendation once persistent (network-noise
victims, in the paper's terms, are transient and recover; broken hosts
don't)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class StragglerConfig:
    window: int = 20                # steps of history per worker
    deadline_mads: float = 6.0      # deadline = median + k * MAD
    persistent_misses: int = 10     # misses (of last window) => evict
    rebalance_step: float = 0.125   # batch fraction moved per rebalance
    min_share: float = 0.25         # floor on a straggler's batch share


@dataclass
class StragglerMitigator:
    n_workers: int
    cfg: StragglerConfig = StragglerConfig()
    times: dict = field(default_factory=dict)      # worker -> [t]
    misses: dict = field(default_factory=dict)
    shares: dict = field(default_factory=dict)     # batch share per worker

    def __post_init__(self):
        for w in range(self.n_workers):
            self.times[w] = []
            self.misses[w] = 0
            self.shares[w] = 1.0

    def record_step(self, step_times: dict) -> dict:
        """step_times: worker -> seconds for this step.
        Returns actions: worker -> 'ok' | 'rebalance' | 'evict'."""
        all_t = np.array(list(step_times.values()))
        med = float(np.median(all_t))
        mad = float(np.median(np.abs(all_t - med))) or 1e-3
        deadline = med + self.cfg.deadline_mads * mad
        actions = {}
        for w, t in step_times.items():
            hist = self.times[w]
            hist.append(t)
            if len(hist) > self.cfg.window:
                hist.pop(0)
            if t > deadline:
                self.misses[w] += 1
            else:
                self.misses[w] = max(0, self.misses[w] - 1)
            if self.misses[w] >= self.cfg.persistent_misses:
                actions[w] = "evict"
            elif t > deadline:
                self.shares[w] = max(self.cfg.min_share,
                                     self.shares[w]
                                     - self.cfg.rebalance_step)
                actions[w] = "rebalance"
            else:
                # recover share gradually when healthy
                self.shares[w] = min(1.0, self.shares[w]
                                     + self.cfg.rebalance_step / 4)
                actions[w] = "ok"
        return actions

    def batch_shares(self) -> dict:
        """Normalized per-worker batch fractions (sum == n_workers)."""
        total = sum(self.shares.values())
        scale = self.n_workers / total
        return {w: s * scale for w, s in self.shares.items()}

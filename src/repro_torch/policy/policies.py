"""Baseline policies: StaticPolicy and EpsilonGreedyPolicy.

StaticPolicy is the vectorized form of "run everything with one routing
mode" (the Default / HIGH-BIAS arms of Fig. 7-10).  EpsilonGreedyPolicy
is a model-free bandit baseline over the same two arms Algorithm 1
arbitrates: it needs no λ/σ calibration and no cost model, so it bounds
how much of Algorithm 1's win comes from the paper's Eq.(2) structure
versus generic explore/exploit adaptation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Hashable

import numpy as np

from repro_torch.core.perf_model import (MAX_OUTSTANDING_PACKETS,
                                   PACKET_PAYLOAD_BYTES,
                                   PUT_FLITS_PER_PACKET)
from repro_torch.policy.types import DecisionBatch, Feedback, KIND_ALLTOALL


@dataclass
class StaticPolicy:
    """Always the same mode; feedback is ignored."""

    mode: Hashable

    def decide(self, batch: DecisionBatch) -> np.ndarray:
        return np.full(len(batch), self.mode, dtype=object)

    def update(self, batch: DecisionBatch, feedback: Feedback) -> None:
        return None


def _eq2_cycles_per_byte(msg_bytes: np.ndarray, latency_cycles: np.ndarray,
                         stalls_per_flit: np.ndarray) -> np.ndarray:
    """Vectorized Eq.(2) per-byte cost — the bandit's loss signal."""
    b = np.maximum(msg_bytes, 1.0)
    packets = np.maximum(1.0, np.ceil(b / PACKET_PAYLOAD_BYTES))
    flits = packets * PUT_FLITS_PER_PACKET
    window = (packets + MAX_OUTSTANDING_PACKETS // 2) \
        / MAX_OUTSTANDING_PACKETS
    t = window * latency_cycles + flits * (stalls_per_flit + 1.0)
    return t / b


@dataclass
class _ArmStats:
    cost: float = 0.0          # EMA of Eq.(2) cycles/byte
    n: int = 0


@dataclass
class EpsilonGreedyPolicy:
    """ε-greedy over (mode_a, mode_b) per call site.

    decide(): with probability ε a row explores a uniform-random arm;
    otherwise it exploits the arm with the lowest EMA Eq.(2)-per-byte
    cost (unobserved arms are tried first).  Fully vectorized: one rng
    draw per row, one automaton touch per (site, kind) group.
    update(): per-arm weighted-mean cost folded into the EMA.

    ε follows the decayed schedule ``eps0 / (1 + k·t)`` where t counts
    prior decide() touches of the site and k is `epsilon_decay`: early
    phases explore, converged phases stop paying the exploration tax
    (constant-ε never beat Algorithm 1 in fig8 cells because it kept
    routing ε of the traffic through the losing arm forever).
    `epsilon_decay=0` recovers the constant-ε bandit.
    """

    mode_a: Hashable
    mode_b: Hashable
    mode_a_alltoall: Hashable = None
    epsilon: float = 0.1
    #: k in eps0 / (1 + k·t); t = prior decide() touches of the site
    epsilon_decay: float = 0.05
    ema: float = 0.3           # EMA weight of the newest cost sample
    seed: int = 0
    _rng: np.random.Generator = None
    _arms: dict = field(default_factory=dict)  # (site, mode) -> _ArmStats
    _site_steps: dict = field(default_factory=dict)  # site -> decide touches
    _pending: list = field(default_factory=list)

    def __post_init__(self):
        if self.mode_a_alltoall is None:
            self.mode_a_alltoall = self.mode_a
        if self._rng is None:
            self._rng = np.random.default_rng(self.seed)

    def _stats(self, site: Hashable, mode: Hashable) -> _ArmStats:
        key = (site, mode)
        st = self._arms.get(key)
        if st is None:
            st = self._arms[key] = _ArmStats()
        return st

    def effective_epsilon(self, site: Hashable) -> float:
        """Current ε at `site`: eps0 / (1 + k·t)."""
        t = self._site_steps.get(site, 0)
        return self.epsilon / (1.0 + self.epsilon_decay * t)

    def decide(self, batch: DecisionBatch) -> np.ndarray:
        n = len(batch)
        modes = np.empty(n, dtype=object)
        pending = []
        # ε is sampled once per site per decide() — a batch mixing kinds
        # at one site is still a single schedule step for that site
        site_eps: dict = {}
        for site, kind, rows in batch.groups():
            a = self.mode_a_alltoall if kind == KIND_ALLTOALL else self.mode_a
            b = self.mode_b
            sa, sb = self._stats(site, a), self._stats(site, b)
            # exploit arm: untried arms first, then lowest EMA cost
            if sa.n == 0:
                exploit = a
            elif sb.n == 0:
                exploit = b
            else:
                exploit = a if sa.cost <= sb.cost else b
            eps = site_eps.setdefault(site, self.effective_epsilon(site))
            explore = self._rng.random(len(rows)) < eps
            coin = self._rng.random(len(rows)) < 0.5
            row_modes = np.full(len(rows), exploit, dtype=object)
            row_modes[explore & coin] = a
            row_modes[explore & ~coin] = b
            modes[rows] = row_modes
            pending.append((site, rows, row_modes))
        for site in site_eps:
            self._site_steps[site] = self._site_steps.get(site, 0) + 1
        self._pending = pending
        return modes

    def update(self, batch: DecisionBatch, feedback: Feedback) -> None:
        if not self._pending:
            return
        if len(feedback) != len(batch):
            raise ValueError("feedback rows must match the decided batch")
        cost = _eq2_cycles_per_byte(batch.msg_bytes,
                                    feedback.latency_cycles,
                                    feedback.stalls_per_flit)
        w = feedback.weight
        for site, rows, row_modes in self._pending:
            for mode in {m for m in row_modes}:
                sel = rows[row_modes == mode]
                tot = float(w[sel].sum()) or 1.0
                c = float((cost[sel] * w[sel]).sum() / tot)
                st = self._stats(site, mode)
                st.cost = c if st.n == 0 else \
                    (1 - self.ema) * st.cost + self.ema * c
                st.n += 1
        self._pending = []

    def reset_samples(self, site_filter=None) -> int:
        """Fault-epoch hook (docs/faults.md): drop the per-arm cost EMAs
        for the matching sites — pre-fault costs describe a link set
        that no longer exists.  The decayed-ε schedule restarts with
        them, so the bandit re-explores the changed machine.  Returns
        the number of sites reset."""
        sites = {k[0] for k in self._arms} | set(self._site_steps)
        hit = [s for s in sites
               if site_filter is None or site_filter(s)]
        for s in hit:
            self._site_steps.pop(s, None)
        for key in [k for k in self._arms if k[0] in set(hit)]:
            del self._arms[key]
        return len(hit)

"""Network-noise estimation methodology — paper §3.

Three rules, each of which this module encodes as an executable guard or
statistic (they are exercised by benchmarks/fig3..5 and the tests):

  §3.1 Fix the allocation: only samples taken inside the *same* allocation
       are comparable (placement alone spans 3 orders of magnitude).
       -> NoiseReport refuses to pool samples across allocation ids.

  §3.2 Correlation is not causation: raw counter values grow with the
       observation window even for an idle app.
       -> only CounterDelta (windowed, normalized) quantities enter reports.

  §3.3 Communication-time variance is not network noise: host-side effects
       (OS noise, imbalance) inflate MPI-call variance.
       -> noise is quantified on NIC *latency* samples via the QCD, with the
          execution-time QCD reported alongside only as an upper bound.

The dispersion statistic is the Quartile Coefficient of Dispersion:
    QCD = (Q3 - Q1) / (Q3 + Q1)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def iqr(samples) -> float:
    """Inter-quartile range Q3 - Q1."""
    q1, q3 = np.percentile(np.asarray(samples, dtype=np.float64), [25, 75])
    return float(q3 - q1)


def qcd(samples) -> float:
    """Quartile coefficient of dispersion (paper §3.3)."""
    q1, q3 = np.percentile(np.asarray(samples, dtype=np.float64), [25, 75])
    denom = q3 + q1
    if denom == 0.0:
        return 0.0
    return float((q3 - q1) / denom)


@dataclass(frozen=True)
class NoiseReport:
    """Noise summary for one (allocation, workload, routing-mode) cell."""

    allocation_id: str
    n_samples: int
    median_exec_us: float
    qcd_exec: float          # upper bound on noise (includes host effects)
    median_latency_us: float
    qcd_latency: float       # the network-noise estimate (paper §3.3)
    mean_stalls_per_flit: float
    qcd_stalls: float
    outlier_ratio: float     # fraction of samples > 10x median (Fig. 3 tails)

    @property
    def network_noise(self) -> float:
        """The paper's network-noise metric: dispersion of NIC latency."""
        return self.qcd_latency


class AllocationMismatch(ValueError):
    """Raised when samples from different allocations are pooled (§3.1)."""


@dataclass
class NoiseEstimator:
    """Accumulates per-iteration samples, enforcing the §3 rules."""

    allocation_id: str
    exec_us: list = field(default_factory=list)
    latency_us: list = field(default_factory=list)
    stalls: list = field(default_factory=list)

    def add(self, *, allocation_id: str, exec_us: float,
            latency_us: float, stalls_per_flit: float) -> None:
        if allocation_id != self.allocation_id:
            raise AllocationMismatch(
                f"sample from allocation {allocation_id!r} cannot be pooled "
                f"with {self.allocation_id!r} (paper §3.1: fix the allocation)"
            )
        self.exec_us.append(exec_us)
        self.latency_us.append(latency_us)
        self.stalls.append(stalls_per_flit)

    def report(self) -> NoiseReport:
        ex = np.asarray(self.exec_us, dtype=np.float64)
        la = np.asarray(self.latency_us, dtype=np.float64)
        st = np.asarray(self.stalls, dtype=np.float64)
        med = float(np.median(ex)) if ex.size else 0.0
        return NoiseReport(
            allocation_id=self.allocation_id,
            n_samples=int(ex.size),
            median_exec_us=med,
            qcd_exec=qcd(ex) if ex.size else 0.0,
            median_latency_us=float(np.median(la)) if la.size else 0.0,
            qcd_latency=qcd(la) if la.size else 0.0,
            mean_stalls_per_flit=float(st.mean()) if st.size else 0.0,
            qcd_stalls=qcd(st) if st.size else 0.0,
            outlier_ratio=float((ex > 10.0 * med).mean()) if ex.size else 0.0,
        )


def estimate_noise(allocation_id: str, exec_us, latency_us,
                   stalls_per_flit) -> NoiseReport:
    """One-shot NoiseReport from parallel sample arrays."""
    est = NoiseEstimator(allocation_id)
    for e, l, s in zip(exec_us, latency_us, stalls_per_flit):
        est.add(allocation_id=allocation_id, exec_us=e, latency_us=l,
                stalls_per_flit=s)
    return est.report()

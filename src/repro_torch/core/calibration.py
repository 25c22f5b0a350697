"""Scaling-factor calibration (λ, σ) — paper §4.2.

λ maps the latency observed under ADAPTIVE to an estimate of the latency
under HIGH BIAS (λ = median L_bs / L_ad over benchmark sweeps); σ does the
same for stalls.  The paper derives them "by considering a median case over
several runs of different microbenchmarks in different allocations"; we do
exactly that against the Dragonfly simulator (benchmarks/fig7 feeds this).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Tuple

import numpy as np


@dataclass(frozen=True)
class ScalingFactors:
    lambda_latency: float   # λ: L_bs ≈ λ · L_ad
    sigma_stalls: float     # σ: s_bs ≈ σ · s_ad
    n_runs: int

    def as_router_kwargs(self) -> dict:
        return {"lambda_latency": self.lambda_latency,
                "sigma_stalls": self.sigma_stalls}


def calibrate_scaling_factors(
    paired_observations: Iterable[Tuple[float, float, float, float]],
    eps: float = 1e-9,
) -> ScalingFactors:
    """paired_observations: iterable of (L_ad, s_ad, L_bs, s_bs) tuples, one
    per (microbenchmark, allocation) run with the two modes alternated on
    successive iterations (the paper's §5 protocol, which cancels transient
    noise).  Returns median ratios."""
    lam, sig = [], []
    n = 0
    for l_ad, s_ad, l_bs, s_bs in paired_observations:
        n += 1
        if l_ad > eps:
            lam.append(l_bs / l_ad)
        if s_ad > eps:
            sig.append(s_bs / s_ad)
    if not lam and not sig:
        raise ValueError("no usable observations for calibration")
    return ScalingFactors(
        lambda_latency=float(np.median(lam)) if lam else 1.0,
        sigma_stalls=float(np.median(sig)) if sig else 1.0,
        n_runs=n,
    )

"""Table 1 — correlation is not causation (§3.2).

An *idle* application observes the network for 1s vs 2s: the tile-counter
flit totals scale with the observation window (spurious correlation with
"execution time"), while the windowed flit RATE is invariant — the paper's
normalization fix.

Counterpart of ``benchmarks/table1_correlation.py`` on the port's
simulator:

    PYTHONPATH=src python -m repro_torch.benchmarks.table1_correlation [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import DAINT, bench_topology, cli, emit
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import DragonflySimulator, SimParams
from repro_torch.dragonfly.routing import RoutingPolicy


def run(idle_seconds=(1.0, 2.0), topology=None, device=None):
    topo = bench_topology(topology, DAINT)
    rows = []
    for idle_s in idle_seconds:
        sim = DragonflySimulator(topo, SimParams(seed=3), device=device)
        t0, f0 = sim.clock_s, sim.total_flits_all_jobs
        pol = RoutingPolicy(RoutingMode.ADAPTIVE_0)
        while sim.clock_s - t0 < idle_s:
            # the app sends NOTHING; only other jobs tick
            sim.run_phase(np.zeros(0, np.int64), np.zeros(0, np.int64),
                          np.zeros(0), pol, None)
        rows.append({"idle_s": sim.clock_s - t0,
                     "flits": sim.total_flits_all_jobs - f0})
    return rows


def main(full: bool = False, topology=None, device=None):
    rows = run(topology=topology, device=device)
    r1, r2 = rows
    emit("table1.idle1s.flits", r1["flits"], f"window={r1['idle_s']:.2f}s")
    emit("table1.idle2s.flits", r2["flits"],
         f"raw_ratio={r2['flits'] / max(r1['flits'], 1e-9):.2f} (~2x: "
         "correlation without causation)")
    rate1 = r1["flits"] / r1["idle_s"]
    rate2 = r2["flits"] / r2["idle_s"]
    emit("table1.check.rate_invariant",
         abs(rate2 - rate1) / max(rate1, 1e-9) * 100,
         "pct_diff_of_normalized_rate (the 3.2 fix)")
    return rows


if __name__ == "__main__":
    args = cli(__doc__, policy=False)
    main(full=args.full, topology=args.topology, device=args.device)

"""Fig. 8/9 — microbenchmarks x input sizes x routing strategies.

Piz-Daint-like: 1024 ranks over 6 of 12 groups (the paper: 1024 nodes, 257
routers, 6 groups).  Cori-like: 64 ranks over 5 of 8 groups.  Times are
normalized to the Default (ADAPTIVE/INCR-MINIMAL) median; the x-axis
annotation carries the %-of-traffic Application-Aware sent via Default.

Counterpart of ``benchmarks/fig8_microbench.py`` on the port's simulator:

    PYTHONPATH=src python -m repro_torch.benchmarks.fig8_microbench [--full] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import (CORI, DAINT, MODE_LABEL,
                                           bench_topology, boxstats, cli,
                                           emit, group_spread)
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import DragonflySimulator, SimParams
from repro_torch.dragonfly.topology import make_allocation
from repro_torch.dragonfly.traffic import run_benchmark

SWEEP = {
    "pingpong": [dict(size=1024), dict(size=1 << 20)],
    "allreduce": [dict(elements=1024), dict(elements=262144)],
    "alltoall": [dict(size_per_pair=1024), dict(size_per_pair=65536)],
    "barrier": [dict()],
    "broadcast": [dict(size=4096), dict(size=4 << 20)],
    "halo3d": [dict(nx=256), dict(nx=768)],
    "sweep3d": [dict(nx=256), dict(nx=768)],
}


def run(machine: str = "daint", iters: int = 8, seed: int = 0,
        max_flows: int = 60_000, full_scale: bool = True,
        policy: str = "app_aware", topology=None, sweep=SWEEP,
        device=None):
    """`policy` picks the adaptive arm ("app_aware" | "eps_greedy" |
    "static") — the repro_torch.policy engine driving the third column.
    `topology` (a make_topology spec) swaps the machine out for both
    the daint- and cori-shaped passes; ranks are capped to fit.
    `sweep` ({pattern: [args, ...]}) picks the rows."""
    modes = (RoutingMode.ADAPTIVE_0, RoutingMode.ADAPTIVE_3, policy)
    if machine == "daint":
        topo = bench_topology(topology, DAINT)
        n_ranks, groups = ((1024 if full_scale else 256),
                           group_spread(topo, 6))
    else:
        topo = bench_topology(topology, CORI)
        n_ranks, groups = 64, group_spread(topo, 5)
    n_ranks = min(n_ranks, topo.n_nodes)
    out = {}
    for bench, sweeps in sweep.items():
        for args in sweeps:
            sim = DragonflySimulator(topo, SimParams(seed=seed,
                                                     max_flows=max_flows),
                                     device=device)
            al = make_allocation(topo, n_ranks, spread=groups, seed=seed)
            res = run_benchmark(sim, al, bench, args, iters, modes=modes,
                                use_plans=True)
            key = f"{bench}." + (".".join(f"{v}" for v in args.values())
                                 or "na")
            med_def = np.median([r.time_us
                                 for r in res[RoutingMode.ADAPTIVE_0]])
            row = {"default_median_us": float(med_def)}
            for m in modes:
                ts = np.array([r.time_us for r in res[m]])
                row[MODE_LABEL[m]] = {
                    "norm_median": float(np.median(ts) / med_def),
                    "qcd": boxstats(ts)["qcd"],
                }
            aa = res[policy]
            frac = np.mean([
                sum(v for k, v in r.mode_bytes.items()
                    if k in (RoutingMode.ADAPTIVE_0, RoutingMode.ADAPTIVE_1))
                / max(sum(r.mode_bytes.values()), 1e-9) for r in aa])
            row["policy_pct_default_traffic"] = float(frac * 100)
            out[key] = row
    return out


def main(full: bool = False, policy: str = "app_aware", topology=None,
         device=None):
    label = MODE_LABEL[policy]
    for machine, tag in (("daint", "fig8"), ("cori", "fig9")):
        if not full and machine == "cori":
            continue
        res = run(machine, iters=10 if full else 4,
                  max_flows=80_000 if full else 30_000,
                  full_scale=full, policy=policy, topology=topology,
                  device=device)
        wins = 0
        cells = 0
        for key, row in res.items():
            emit(f"{tag}.{key}.default", row["default_median_us"],
                 f"norm=1.0;qcd={row['default']['qcd']:.3f}")
            emit(f"{tag}.{key}.highbias",
                 row["default_median_us"] * row["highbias"]["norm_median"],
                 f"norm={row['highbias']['norm_median']:.3f}")
            emit(f"{tag}.{key}.{label}",
                 row["default_median_us"] * row[label]["norm_median"],
                 f"norm={row[label]['norm_median']:.3f};"
                 f"pct_default={row['policy_pct_default_traffic']:.0f}%")
            # the best static arm: default is 1.0 by normalisation
            best = min(1.0, row["highbias"]["norm_median"])
            cells += 1
            if row[label]["norm_median"] <= best * 1.10:
                wins += 1
        emit(f"{tag}.check.{label}_within10pct_of_best",
             wins / max(cells, 1) * 100, f"{wins}/{cells} cells")
    return None


if __name__ == "__main__":
    args = cli(__doc__)
    main(full=args.full, policy=args.policy, topology=args.topology,
         device=args.device)

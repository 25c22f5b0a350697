"""Fig. 3 — ping-pong (16 KiB) across allocation tiers on Piz-Daint-like.

Reproduces: flat-ish medians, massively growing variance with tier, and
outliers orders of magnitude above the median for inter-group placements
(which pull the mean into the outlier regime).

Counterpart of ``benchmarks/fig3_allocation.py`` on the port's simulator:

    PYTHONPATH=src python -m repro_torch.benchmarks.fig3_allocation [--full] [--device cpu]
"""

from __future__ import annotations

from repro_torch.benchmarks.common import (DAINT, bench_topology, boxstats,
                                           cli, emit)
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import DragonflySimulator, SimParams
from repro_torch.dragonfly.routing import RoutingPolicy
from repro_torch.dragonfly.topology import make_allocation
from repro_torch.dragonfly.traffic import pingpong, run_iteration

TIERS = ("inter_nodes", "inter_blades", "inter_chassis", "inter_groups")


def run(iters: int = 120, seeds: int = 4, size: int = 16384,
        topology=None, device=None):
    topo = bench_topology(topology, DAINT)
    out = {}
    for tier in TIERS:
        ts = []
        for seed in range(seeds):
            sim = DragonflySimulator(topo, SimParams(seed=seed),
                                     device=device)
            al = make_allocation(topo, 2, spread=tier, seed=seed)
            for _ in range(iters):
                ts.append(run_iteration(
                    sim, al, pingpong(2, size),
                    RoutingPolicy(RoutingMode.ADAPTIVE_0)).time_us)
        out[tier] = boxstats(ts)
    return out


def main(full: bool = False, topology=None, device=None):
    res = run(iters=150 if full else 60, seeds=4 if full else 2,
              topology=topology, device=device)
    for tier, st in res.items():
        emit(f"fig3.pingpong16k.{tier}", st["median"],
             f"mean={st['mean']:.1f};max={st['max']:.1f};iqr_q3={st['q3']:.1f}")
    # the paper's headline observations as derived checks
    ladder_ok = (res["inter_groups"]["median"]
                 >= res["inter_nodes"]["median"])
    tail = res["inter_groups"]["max"] / max(res["inter_groups"]["median"],
                                            1e-9)
    emit("fig3.check.median_ladder", 1.0 if ladder_ok else 0.0,
         f"tail_ratio={tail:.0f}x")
    return res


if __name__ == "__main__":
    args = cli(__doc__, policy=False)
    main(full=args.full, topology=args.topology, device=args.device)

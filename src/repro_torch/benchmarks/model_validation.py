"""§2.4 validation — Eq.(2) estimates vs simulated ping-pong times across
allocations and message sizes (the paper reports 79% average correlation
over 40 allocations, 128B..16MiB).

Counterpart of ``benchmarks/model_validation.py`` on the port's
simulator:

    PYTHONPATH=src python -m repro_torch.benchmarks.model_validation [--full] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import DAINT, bench_topology, cli, emit
from repro_torch.core.perf_model import predict_transmission_cycles
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import DragonflySimulator, SimParams
from repro_torch.dragonfly.routing import RoutingPolicy
from repro_torch.dragonfly.topology import make_allocation
from repro_torch.dragonfly.traffic import pingpong, run_iteration

SIZES = (128, 1024, 16384, 262144, 4 << 20, 16 << 20)


def run(n_allocations: int = 40, iters: int = 6, topology=None,
        device=None):
    topo = bench_topology(topology, DAINT)
    corrs = []
    for size in SIZES:
        meas, est = [], []
        for seed in range(n_allocations):
            spread = ("inter_groups", "inter_chassis",
                      "inter_blades", "scattered")[seed % 4]
            sim = DragonflySimulator(topo, SimParams(seed=seed),
                                     device=device)
            al = make_allocation(topo, 2, spread=spread, seed=seed)
            ts, es = [], []
            for _ in range(iters):
                r = run_iteration(sim, al, pingpong(2, size),
                                  RoutingPolicy(RoutingMode.ADAPTIVE_0))
                ts.append(r.time_us)
                es.append(predict_transmission_cycles(
                    size, r.mean_latency_us * 1e3, r.mean_stalls) / 1e3 * 2)
            meas.append(np.median(ts))
            est.append(np.median(es))
        c = float(np.corrcoef(meas, est)[0, 1])
        corrs.append(c)
        emit(f"model_validation.{size}B.corr", c * 100, "pct")
    emit("model_validation.mean_corr", float(np.mean(corrs)) * 100,
         "paper_reports_79pct")
    return corrs


def main(full: bool = False, topology=None, device=None):
    return run(n_allocations=40 if full else 12, iters=6 if full else 4,
               topology=topology, device=device)


if __name__ == "__main__":
    args = cli(__doc__, policy=False)
    main(full=args.full, topology=args.topology, device=args.device)

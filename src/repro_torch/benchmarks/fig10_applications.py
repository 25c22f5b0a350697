"""Fig. 10 — real-application traffic under the three routing strategies.

Applications are modeled as their dominant communication pattern plus a
compute/communication duty cycle (the paper's "noise absorption"): e.g.
MILC is halo3d's pattern at ~10% comm fraction, which is why its optimal
routing differs from the pure halo3d microbenchmark — reproduced here.
FFT at 256 vs 64 ranks reproduces the allocation-dependent flip.

Counterpart of ``benchmarks/fig10_applications.py`` on the port's
simulator:

    PYTHONPATH=src python -m repro_torch.benchmarks.fig10_applications [--full] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import (DAINT, MODE_LABEL, bench_topology,
                                           cli, emit, group_spread)
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import DragonflySimulator, SimParams
from repro_torch.dragonfly.routing import RoutingPolicy
from repro_torch.dragonfly.topology import make_allocation
from repro_torch.dragonfly.traffic import (PATTERN_KIND, PATTERNS,
                                           engine_for_arm, run_iteration,
                                           run_iteration_engine)

# app -> (pattern, args, ranks, comm_fraction)
APPS = {
    "cp2k": ("allreduce", dict(elements=65536), 256, 0.35),
    "wrf-b": ("halo3d", dict(nx=512), 256, 0.25),
    "lammps": ("halo3d", dict(nx=384), 256, 0.3),
    "quantum-espresso": ("alltoall", dict(size_per_pair=32768), 256, 0.4),
    "nekbone": ("allreduce", dict(elements=16384), 256, 0.3),
    "milc": ("halo3d", dict(nx=768), 256, 0.1),
    "hpcg": ("allreduce", dict(elements=4096), 256, 0.2),
    "bfs": ("alltoall", dict(size_per_pair=2048), 256, 0.5),
    "fft-256": ("alltoall", dict(size_per_pair=131072), 256, 0.6),
    "fft-64": ("alltoall", dict(size_per_pair=131072), 64, 0.6),
}


def run_app(topo, name, pattern, args, ranks, comm_frac, iters, seed=0,
            policy: str = "app_aware", device=None):
    modes = (RoutingMode.ADAPTIVE_0, RoutingMode.ADAPTIVE_3, policy)
    ranks = min(ranks, topo.n_nodes)
    sim = DragonflySimulator(topo, SimParams(seed=seed, max_flows=40_000),
                             device=device)
    al = make_allocation(topo, ranks, spread=group_spread(topo, 6),
                         seed=seed)
    phases = PATTERNS[pattern](ranks, **args)
    kind = PATTERN_KIND[pattern]
    engine = engine_for_arm(policy, sim, seed=seed)
    rng = np.random.default_rng(seed)
    out = {m: [] for m in modes}
    for _ in range(iters):
        for m in modes:
            if isinstance(m, str):
                r = run_iteration_engine(sim, al, phases, engine,
                                         site=name, kind=kind,
                                         use_plans=True)
            else:
                r = run_iteration(sim, al, phases, RoutingPolicy(m),
                                  use_plans=True)
            comm = r.time_us
            compute = comm * (1 - comm_frac) / max(comm_frac, 1e-3) \
                * rng.lognormal(0, 0.05)
            out[m].append(comm + compute)
    return out


def main(full: bool = False, policy: str = "app_aware", topology=None,
         device=None):
    topo = bench_topology(topology, DAINT)
    iters = 8 if full else 4
    modes = (RoutingMode.ADAPTIVE_0, RoutingMode.ADAPTIVE_3, policy)
    apps = APPS if full else {k: APPS[k] for k in
                              ("cp2k", "milc", "fft-256", "fft-64", "bfs")}
    for name, (pattern, args, ranks, frac) in apps.items():
        res = run_app(topo, name, pattern, args, ranks, frac, iters,
                      policy=policy, device=device)
        med_def = np.median(res[RoutingMode.ADAPTIVE_0])
        for m in modes:
            ts = np.asarray(res[m])
            emit(f"fig10.{name}.{MODE_LABEL[m]}", float(np.median(ts)),
                 f"norm={float(np.median(ts) / med_def):.3f}")
    return None


if __name__ == "__main__":
    args = cli(__doc__)
    main(full=args.full, policy=args.policy, topology=args.topology,
         device=args.device)

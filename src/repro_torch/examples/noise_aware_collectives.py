"""The paper's contribution end to end, through the unified
``repro_torch.policy`` API.  Counterpart of
``examples/noise_aware_collectives.py``:

    PYTHONPATH=src python -m repro_torch.examples.noise_aware_collectives
    PYTHONPATH=src python -m repro_torch.examples.noise_aware_collectives --device cpu

1. Dragonfly substrate: one PolicyEngine per strategy arm — Algorithm 1
   ("app_aware") and the epsilon-greedy bandit baseline — picks per-flow
   routing modes on a simulated Aries system with one vectorised
   ``decide()`` per phase (the Fig. 8 protocol, reduced), beside the
   static ADAPTIVE and HIGH BIAS arms.
2. H100 substrate: the same Policy class arbitrates DIRECT vs
   HIERARCHICAL collective schedules on a 2-pod x 256-card mesh, on the
   cost model at the port's ``H100`` spec (NVIDIA datasheet values, not
   measurements: NVLink 450 GB/s a direction inside a pod, one 400 Gb/s
   NDR port, 50 GB/s, across pods), and reports the pod-boundary bytes
   of a llama3-8b gradient reduce, batched: one engine call decides every
   bucket of a step.  At that spec both link classes drain faster than
   the flit clock, so the stall term is 0 for both modes (ROADMAP C):
   Algorithm 1's first decision, made before any observation, takes
   HIERARCHICAL, and from the first observation on it settles on DIRECT.
   The example prints that outcome as it is: the 4 KiB row HIERARCHICAL,
   the rest DIRECT, and a saving that is only the first step's buckets
   (16 of 512, 3.1 %).
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.analysis import H100
from repro_torch.collectives.modes import CollectiveMode
from repro_torch.collectives.selector import (AppAwareSelector, ICICostModel,
                                              MeshSpec)
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import (DragonflySimulator, DragonflyTopology,
                                   SimParams, TopologyParams,
                                   make_allocation, run_benchmark)
from repro_torch.runtime import resolve_device


def dragonfly_sweep(device) -> dict:
    """Part 1: alltoall, 128 ranks over 6 of 12 groups, 4 arms; the
    medians by arm as multiples of ADAPTIVE's, by size."""
    topo = DragonflyTopology(TopologyParams(n_groups=12))
    alloc = make_allocation(topo, 128, spread="groups:6", seed=0)
    print("== Dragonfly: alltoall sweep, 128 ranks over 6 groups ==")
    out = {}
    for size in (1024, 65536):
        sim = DragonflySimulator(topo, SimParams(seed=0, max_flows=30000),
                                 device=device)
        res = run_benchmark(sim, alloc, "alltoall", dict(size_per_pair=size),
                            iterations=4,
                            modes=(RoutingMode.ADAPTIVE_0,
                                   RoutingMode.ADAPTIVE_3,
                                   "app_aware", "eps_greedy"),
                            use_plans=True)   # alltoall rounds share one plan
        meds = {}
        for mode, rs in res.items():
            label = mode.value if isinstance(mode, RoutingMode) else mode
            meds[label] = float(np.median([r.time_us for r in rs]))
        base = meds["ADAPTIVE_0"]
        out[size] = {k: v / base for k, v in meds.items()}
        row = "  ".join(f"{k}={v:5.2f}x" for k, v in out[size].items())
        print(f"  {size:>7}B/pair: {row}")
    return out


def h100_selection() -> dict:
    """Part 2: the selector's choice by message size and the DCN bytes of
    a llama3-8b gradient reduce (bf16, 16 GiB in 32 MiB buckets, 16
    buckets a step) on the 2 x 256 mesh at ``H100``."""
    print(f"\n== {H100.name} 2x256: Algorithm 1 over collective schedules "
          f"(datasheet links: {H100.ici_bw / 1e9:.0f} GB/s in a pod, "
          f"{H100.dcn_bw / 1e9:.0f} GB/s across pods) ==")
    mesh = MeshSpec(n_pods=2, inner_chips=256)
    sel = AppAwareSelector(ICICostModel(mesh))
    by_size = {}
    for size in (4 << 10, 1 << 20, 32 << 20, 512 << 20):
        m = sel.select(size)
        sel.observe_predicted(size)
        by_size[size] = m.value
        print(f"  {size / 2**20:8.2f} MiB -> {m.value}")

    bucket, grads = 32 << 20, 16 << 30  # llama3-8b bf16 grads
    n, p, i = mesh.total, mesh.n_pods, mesh.inner_chips
    direct = 2 * (n - 1) / n * grads
    aware = 0.0
    # one engine call per training step, deciding all of the step's buckets
    buckets_per_step = 16
    n_steps = (grads // bucket) // buckets_per_step
    for _ in range(n_steps):
        step_sizes = [bucket] * buckets_per_step
        modes = sel.decide_batch(step_sizes, site="grad_step")
        sel.update_predicted(step_sizes)     # dry-run telemetry, one batch
        aware += sum(2 * (p - 1) / p * bucket / i
                     if m is CollectiveMode.HIERARCHICAL
                     else 2 * (n - 1) / n * bucket for m in modes)
    saved = 100 * (1 - aware / direct)
    print(f"\n  grad-reduce DCN bytes: direct={direct / 2**30:.1f} GiB, "
          f"app-aware={aware / 2**30:.2f} GiB ({saved:.1f}% saved)")
    print(f"  engine: {sel.engine.decide_calls} decide() calls for "
          f"{sel.engine.rows_decided} decisions; "
          f"{sel.engine.gated_fraction() * 100:.1f}% of bytes gate-forced")
    return {"modes": by_size, "direct_gib": direct / 2**30,
            "app_aware_gib": aware / 2**30, "saved_pct": saved}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the simulator (default: the "
                         "CUDA card)")
    args = ap.parse_args(argv)
    return {"dragonfly": dragonfly_sweep(resolve_device(args.device)),
            "h100": h100_selection()}


if __name__ == "__main__":
    main()

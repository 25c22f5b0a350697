"""Quickstart — the port's public API in a few lines.

Counterpart of ``examples/quickstart.py``, with its steps and sizes:

    PYTHONPATH=src python -m repro_torch.examples.quickstart               # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

1. build a reduced config, 2. train it a few steps on synthetic data,
3. serve a batch of generations, 4. run the paper's protocol with
Algorithm 1 on a simulated Dragonfly machine (alltoall, 32 KiB a pair,
32 ranks over 4 groups: ADAPTIVE, HIGH BIAS and application-aware
routing alternating).
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import (DragonflySimulator, DragonflyTopology,
                                   SimParams, TopologyParams,
                                   make_allocation, run_benchmark)
from repro_torch.launch.train import train_loop
from repro_torch.runtime import resolve_device
from repro_torch.serve import Request, ServeConfig, ServeEngine


def main(argv=None) -> dict:
    """Runs the four steps; returns the losses, the generated tokens and
    the alltoall medians (µs) by arm."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1+2: train a reduced qwen2 on synthetic data --------------------
    cfg = get_smoke_config("qwen2-1.5b")
    model, _, losses = train_loop(cfg, steps=30, batch=8, seq=64, seed=0,
                                  ckpt_dir=None, ckpt_every=0, lr=3e-3,
                                  device=device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")

    # --- 3: serve --------------------------------------------------------
    engine = ServeEngine(cfg, model, ServeConfig(batch=4, max_len=48),
                         device=device)
    reqs = [Request(prompt=[1, 2, 3, 4], max_new_tokens=8)
            for _ in range(4)]
    generated = [r.out_tokens for r in engine.run(reqs)]
    for toks in generated:
        print("generated:", toks)

    # --- 4: the paper's technique ---------------------------------------
    topo = DragonflyTopology(TopologyParams(n_groups=8))
    sim = DragonflySimulator(topo, SimParams(seed=0), device=device)
    alloc = make_allocation(topo, 32, spread="groups:4", seed=0)
    res = run_benchmark(sim, alloc, "alltoall", dict(size_per_pair=32768),
                        iterations=4, use_plans=True)
    medians = {}
    for mode, rs in res.items():
        label = mode.value if isinstance(mode, RoutingMode) else mode
        medians[label] = float(np.median([r.time_us for r in rs]))
        print(f"alltoall 32KiB x 32 ranks [{label:12s}] "
              f"median {medians[label]:9.1f} us")
    return {"losses": losses, "generated": generated, "medians": medians}


if __name__ == "__main__":
    main()

"""Simulator phase performance of the port on the card.

Counterpart of ``benchmarks/perf_sim.py``, with the port's two arms in
place of the reference's backends (the port has no NumPy or reference
kernel):

  * plan      — a repeated planned phase (the fig7/fig8/fig10 shape: the
                same traffic pattern, phase after phase): ``phase_s``,
                ``flows_per_s`` and per-stage wall times ``stages_s``;
  * lockstep  — one round of a sweep column: B cells (one simulator
                each, same seed, the victim arms ADAPTIVE_0, ADAPTIVE_3,
                ADAPTIVE_1), planless, through ``run_phase_batch`` (one
                batched dispatch), against the same B cells through B
                sequential ``run_phase`` calls; both timed in this call,
                dispatches counted from ``torch_backend.PIPELINE_CALLS``.

Every timed region ends in a device synchronisation.  Emits the
``name,us_per_call,derived`` CSV rows all benchmarks print, and writes
the JSON document only to ``--out``:

    PYTHONPATH=src python -m repro_torch.benchmarks.perf_sim [--smoke | --full] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import emit
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import (DragonflySimulator, DragonflyTopology,
                                   SimParams, TopologyParams)
from repro_torch.dragonfly import torch_backend
from repro_torch.dragonfly.routing import RoutingPolicy
from repro_torch.dragonfly.simulator import run_phase_batch
from repro_torch.dragonfly.topology import make_allocation
from repro_torch.runtime import resolve_device

SCHEMA = "bench_sim_torch/v1"

#: the lockstep column's cells: one victim arm each
ARMS = (RoutingMode.ADAPTIVE_0, RoutingMode.ADAPTIVE_3,
        RoutingMode.ADAPTIVE_1)


def _phase_inputs(topo: DragonflyTopology, n_flows: int, seed: int = 42):
    """A pareto-sized random many-to-many phase (alltoall-ish shape)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, topo.params.n_nodes, size=n_flows)
    dst = (src + rng.integers(1, topo.params.n_nodes, size=n_flows)) \
        % topo.params.n_nodes
    size = rng.pareto(1.2, size=n_flows) * 65536 + 1024
    return src, dst, size


def _timed(fn, device) -> float:
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def time_plan(topo, src, dst, size, alloc, *, phases: int, device):
    """(phase_s, compile_s, stages_s, last FlowResult) of a repeated
    planned phase: the first call (plan, device pinning, kernel build)
    apart, one settle call, then ``phases`` timed."""
    sim = DragonflySimulator(topo, SimParams(seed=0, profile_stages=True),
                             device=device)
    pol = RoutingPolicy(RoutingMode.ADAPTIVE_0)
    res = []

    def one():
        res.append(sim.run_phase(src, dst, size, pol, alloc,
                                 plan=sim.plan_for(src, dst, size)))

    first_s = _timed(one, sim.device)
    one()
    sim.stage_time_s.clear()
    dt = _timed(lambda: [one() for _ in range(phases)], sim.device) / phases
    stages = {k: v / phases for k, v in sim.stage_time_s.items()}
    return dt, max(0.0, first_s - dt), stages, res[-1]


def column_calls(topo, src, dst, size, alloc, device, seed: int = 0):
    """One sweep column's round: a fresh simulator per arm, same seed."""
    return [(DragonflySimulator(topo, SimParams(seed=seed), device=device),
             dict(src_nodes=src, dst_nodes=dst, bytes_=size,
                  policy=RoutingPolicy(arm), allocation=alloc))
            for arm in ARMS]


def time_lockstep(topo, src, dst, size, alloc, *, rounds: int, device):
    """Seconds per round of the column in lockstep and sequentially (one
    warm-up round each), the dispatches each made per round, and the
    largest relative ``t_us`` gap between the two runs' last rounds."""
    out, last = {}, {}
    for name in ("lockstep", "sequential"):
        calls = column_calls(topo, src, dst, size, alloc, device)
        dev = calls[0][0].device

        def one_round():
            if name == "lockstep":
                last[name] = run_phase_batch(calls)
            else:
                last[name] = [sim.run_phase(**kw) for sim, kw in calls]

        one_round()
        before = dict(torch_backend.PIPELINE_CALLS)
        dt = _timed(lambda: [one_round() for _ in range(rounds)], dev)
        calls_made = {k: (torch_backend.PIPELINE_CALLS[k] - before[k])
                      / rounds for k in before}
        out[name] = {"round_s": dt / rounds, "dispatches": calls_made}
    gap = max(float(np.max(np.abs(a.t_us / b.t_us - 1.0)))
              for a, b in zip(last["lockstep"], last["sequential"]))
    return out, gap


def run(n_flows: int, phases: int, out_path: str | None = None,
        device=None):
    device = resolve_device(device)
    topo = DragonflyTopology(TopologyParams(n_groups=12))
    src, dst, size = _phase_inputs(topo, n_flows)
    alloc = make_allocation(topo, min(64, n_flows), spread="inter_groups",
                            seed=3)
    dt, compile_s, stages, _ = time_plan(topo, src, dst, size, alloc,
                                         phases=phases, device=device)
    plan = {"phase_s": dt, "phases_per_s": 1.0 / dt,
            "flows_per_s": n_flows / dt, "compile_s": compile_s,
            "stages_s": stages}
    emit("perf_sim.plan.phase", dt * 1e6,
         f"flows_per_s={n_flows / dt:.0f} compile_s={compile_s:.3f}")
    col, gap = time_lockstep(topo, src, dst, size, alloc, rounds=phases,
                             device=device)
    for name, st in col.items():
        emit(f"perf_sim.{name}.round", st["round_s"] * 1e6,
             f"cells={len(ARMS)};dispatches_per_round="
             f"{sum(st['dispatches'].values()):g}")
    ratio = col["sequential"]["round_s"] / col["lockstep"]["round_s"]
    emit("perf_sim.lockstep.speedup", ratio,
         f"x;t_us_max_rel_gap={gap:.3e}")
    doc = {
        "schema": SCHEMA,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "flows": int(n_flows),
        "phases_timed": int(phases),
        "topology": {"n_groups": 12, "n_links": int(topo.n_links)},
        "plan": plan,
        "lockstep": {"cells": len(ARMS), **col,
                     "sequential_over_lockstep": ratio,
                     "t_us_max_rel_gap": gap},
    }
    if out_path:
        pathlib.Path(out_path).write_text(json.dumps(doc, indent=2,
                                                     sort_keys=True) + "\n")
    return doc


def main(full: bool = False, smoke: bool = False,
         out: str | None = None, device=None) -> dict:
    n_flows, phases = (50_000, 5) if not smoke else (4_000, 3)
    if full:
        n_flows, phases = 120_000, 5
    return run(n_flows, phases, out, device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small pass (4k flows)")
    ap.add_argument("--full", action="store_true",
                    help="the main path's size (120k flows)")
    ap.add_argument("--out", default=None,
                    help="output JSON path (default: write none)")
    ap.add_argument("--device", default=None,
                    help="torch device of the simulators (default: the "
                         "CUDA card)")
    args = ap.parse_args()
    main(full=args.full, smoke=args.smoke, out=args.out, device=args.device)

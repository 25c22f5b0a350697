"""Congestion-notification matrix -> BENCH_notifications.json.

The notification-channel headline artifact: a four-way routing
comparison — static-minimal vs UGAL-adaptive vs app-aware (Algorithm 1)
vs notification-driven (SimParams.notify_* + NotificationPolicy,
docs/policy_api.md) — over two surfaces:

  * workload cells: the fig7/fig8 microbenchmark protocol (alternate
    arms on successive iterations inside ONE allocation) on a
    notification-enabled simulator, recording per-arm iteration medians
    and the cell's congestion_notifications NIC-counter total;
  * tenancy cells: the halo3d-victim / alltoall-aggressor mix from the
    interference matrix, but with a 64 KiB-per-pair aggressor heavy
    enough to push hot links past the notification threshold — victim
    slowdown per arm plus the victim's own notification count (§3.2:
    counters are allocation-scoped, so the victim only sees its flows).

Qualitative target (checked, not asserted): on at least one tenancy
cell the notification-driven victim beats the UGAL-adaptive victim
*while real notification events fired* — a zero-event "win" would just
be baseline jitter, so ``checks.wins_with_events_cells`` requires both.

Counterpart of ``benchmarks/notification_matrix.py`` on the port's
simulator.  Emits the ``name,us_per_call,derived`` CSV rows all
benchmarks print, and writes the bench_notifications/v1 JSON document
only to ``--out``:

    PYTHONPATH=src python -m repro_torch.benchmarks.notification_matrix [--smoke | --full] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from repro_torch.benchmarks.common import emit
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import (DragonflySimulator, SimParams,
                             make_topology)
from repro_torch.dragonfly.topology import make_allocation
from repro_torch.dragonfly.traffic import run_benchmark
from repro_torch.tenancy import InterferenceEngine, TenancyMix, Workload

SCHEMA = "bench_notifications/v1"

#: the machine every cell runs on (the calibrated notification
#: threshold below is specific to its link speeds — override with
#: --topology at your own risk, the checks may not hold elsewhere)
TOPOLOGY = "aries:n_groups=6,chassis_per_group=2,blades_per_chassis=8"

#: the four routing arms (matrix columns).  RoutingMode entries are the
#: static/adaptive hardware arms; strings are repro_torch.policy engines.
ARMS = {
    "minimal": RoutingMode.ADAPTIVE_3,
    "adaptive": RoutingMode.ADAPTIVE_0,
    "app_aware": "app_aware",
    "notification": "notification",
}

#: notification-channel calibration (docs/architecture.md): hot links
#: under the heavy mix sit at 100s of µs of queue-to-drain, calm links
#: well under 100 µs — 250 µs separates them cleanly; the 0.5 clear
#: fraction + 1-phase delay are the two-level hysteresis defaults.
NOTIFY = dict(notify_threshold_s=250e-6, notify_clear_frac=0.5,
              notify_delay_phases=1, notify_penalty_s=300e-6)

#: fig7/fig8-surface workload cells: pattern, args, ranks, placement
WORKLOADS = {
    "fig7_pingpong_4MiB": ("pingpong", {"size": 4 << 20}, 2,
                           "inter_groups"),
    "fig8_alltoall_64KiB": ("alltoall", {"size_per_pair": 65536}, 64,
                            "scattered"),
    "fig8_halo3d": ("halo3d", {"nx": 64, "var_bytes": 8, "vars_": 4}, 64,
                    "scattered"),
}


def make_mix(scale: float = 1.0) -> TenancyMix:
    """Heavy interference mix: the fault-matrix victim, but the
    aggressor moves 64 KiB per pair — enough sustained load that hot
    global links genuinely cross the notification threshold (the 8 KiB
    interference-matrix mix never fires a flag at 250 µs)."""
    r = lambda n: max(8, int(n * scale))  # noqa: E731
    return TenancyMix("halo3d-vs-heavy-alltoall", (
        Workload("halo3d", "halo3d", r(64),
                 {"nx": 64, "var_bytes": 8, "vars_": 4}),
        Workload("alltoall", "alltoall", r(96),
                 {"size_per_pair": 65536},
                 arm=RoutingMode.ADAPTIVE_0)))


def run_workload_cells(topo_spec: str, iters: int, seed: int,
                       device=None) -> dict:
    """fig7/fig8 protocol on a notification-enabled simulator: one sim
    and one allocation per cell, arms alternating per iteration."""
    topo = make_topology(topo_spec)
    cells: dict = {}
    for cell_name, (pattern, args, n_ranks, spread) in WORKLOADS.items():
        sim = DragonflySimulator(topo, SimParams(seed=seed, **NOTIFY),
                                 device=device)
        alloc = make_allocation(topo, n_ranks, spread=spread, seed=seed)
        res = run_benchmark(sim, alloc, pattern, args, iters,
                            modes=tuple(ARMS.values()))
        nic = sim.counters.get(alloc.allocation_id)
        events = int(nic.congestion_notifications) if nic else 0
        cell = {"topology": topo_spec, "pattern": pattern,
                "ranks": int(alloc.n_ranks), "spread": spread,
                "iterations": int(iters),
                "notification_events": events,
                "notify_epochs": int(sim.notify_epoch()), "arms": {}}
        for label, arm in ARMS.items():
            ts = [r.time_us for r in res[arm]]
            cell["arms"][label] = {
                "median_us": float(np.median(ts)),
                "p99_us": float(np.percentile(ts, 99)),
            }
            emit(f"notif.{cell_name}.{label}", float(np.median(ts)),
                 f"events={events}")
        cells[cell_name] = cell
    return cells


def run_tenancy_cells(topo_spec: str, rounds: int, scale: float,
                      seed: int, device=None) -> dict:
    """The four-way victim-slowdown comparison on the heavy mix.

    Ambient background OFF for the same reason as the other matrices:
    pareto bg draws would decorrelate the run-alone baseline's RNG
    stream and drown the notification signal.
    """
    params = SimParams(seed=seed, bg_enable=False, **NOTIFY)
    mix = make_mix(scale)
    cells: dict = {}
    for label, arm in ARMS.items():
        eng = InterferenceEngine(topo_spec, params, seed=seed,
                                 device=device)
        res = eng.run_mix(mix.with_victim_arm(arm), rounds=rounds)
        vic = res.victim_report
        events = int(vic.nic.congestion_notifications)
        cells[label] = {
            "topology": topo_spec,
            "mix": mix.name,
            "victim_slowdown": vic.slowdown,
            "victim_time_us": vic.time_us,
            "victim_alone_us": vic.alone_time_us,
            "victim_nonmin_fraction": vic.nonmin_fraction,
            "notification_events": events,
        }
        emit(f"notif.tenancy.{mix.name}.{label}", vic.time_us,
             f"slowdown={vic.slowdown:.3f};events={events}")
    return {mix.name: cells}


def run(rounds: int, scale: float, iters: int, seed: int,
        out_path: str | None = None, topo_spec: str | None = None,
        device=None) -> dict:
    topo_spec = topo_spec or TOPOLOGY
    workloads = run_workload_cells(topo_spec, iters, seed, device=device)
    tenancy = run_tenancy_cells(topo_spec, rounds, scale, seed,
                                device=device)

    # checks: the notification win must coincide with real events —
    # run-alone baselines pay counter-read overhead, so a zero-event
    # cell that "wins" is measuring jitter, not routing
    beats = [m for m, row in tenancy.items()
             if row["notification"]["victim_slowdown"]
             < row["adaptive"]["victim_slowdown"]]
    fired = [m for m, row in tenancy.items()
             if row["notification"]["notification_events"] > 0]
    wins = sorted(set(beats) & set(fired))
    emit("notif.check.beats_adaptive", len(beats),
         f"{len(beats)}/{len(tenancy)} mixes")
    emit("notif.check.events_fired", len(fired),
         f"{len(fired)}/{len(tenancy)} mixes")
    emit("notif.check.wins_with_events", len(wins),
         f"{len(wins)}/{len(tenancy)} mixes")

    doc = {
        "schema": SCHEMA,
        "rounds": int(rounds),
        "iterations": int(iters),
        "seed": int(seed),
        "topology": topo_spec,
        "notify_params": {k: float(v) for k, v in NOTIFY.items()},
        "policies": list(ARMS),
        "workloads": workloads,
        "matrix": tenancy,
        "checks": {
            "notification_beats_adaptive_cells": beats,
            "notification_events_fired_cells": fired,
            "wins_with_events_cells": wins,
        },
    }
    if out_path:
        pathlib.Path(out_path).write_text(json.dumps(doc, indent=2,
                                                     sort_keys=True) + "\n")
    return doc


def main(full: bool = False, smoke: bool = False,
         out: str | None = None, topology: str | None = None,
         device=None) -> dict:
    # default = the calibrated configuration the checks were validated
    # on (rounds=8, full mix); --full only widens the workload medians
    rounds, scale, iters = 8, 1.0, 6
    if smoke:
        rounds, scale, iters = 6, 0.5, 3
    if full:
        iters = 10
    return run(rounds, scale, iters, seed=7, out_path=out,
               topo_spec=topology, device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small CI pass (shrunken mix, fewer rounds)")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale pass (more workload iterations)")
    ap.add_argument("--out", default=None,
                    help="output JSON path (default: write none)")
    ap.add_argument("--topology", default=None,
                    help="make_topology spec replacing the calibrated "
                         "aries machine (checks may not hold elsewhere)")
    ap.add_argument("--device", default=None,
                    help="torch device of the simulators (default: the "
                         "CUDA card)")
    args = ap.parse_args()
    main(full=args.full, smoke=args.smoke, out=args.out,
         topology=args.topology, device=args.device)

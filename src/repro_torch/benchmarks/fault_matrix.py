"""Fault-injection matrix -> BENCH_faults.json.

The repro_torch.faults headline artifact: a (topology x fault-scenario x
victim-policy) grid on the multi-tenant engine.  Every cell runs the
halo3d-victim / alltoall-aggressor mix under a deterministic seeded
FaultSchedule (docs/faults.md) and records the victim's slowdown vs a
CLEAN run-alone baseline, its stranded-flow count, and its recovery
(rounds / time back to the pre-fault per-round baseline after the last
fault clears) — static-minimal vs adaptive vs app_aware, side by side.

Qualitative targets:
  * link failures inflate every policy's victim slowdown (faults are
    charged against a healthy-machine baseline, so slowdown > 1);
  * policies recover after the schedule clears (recovery_rounds >= 0
    in most cells — a -1 cell means that policy never re-converged).

Counterpart of ``benchmarks/fault_matrix.py`` on the port's simulator.
Emits the ``name,us_per_call,derived`` CSV rows all benchmarks print,
and writes the bench_faults/v1 JSON document only to ``--out``:

    PYTHONPATH=src python -m repro_torch.benchmarks.fault_matrix [--smoke | --full] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.benchmarks.common import emit
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import SimParams
from repro_torch.faults import (FaultSchedule, link_degrade, link_down,
                                link_flap, router_down)
from repro_torch.tenancy import InterferenceEngine, TenancyMix, Workload

SCHEMA = "bench_faults/v1"

#: the three machines the matrix spans (aries + dragonfly +
#: dragonfly_plus) — label -> make_topology spec
TOPOLOGIES = {
    "aries": "aries:n_groups=6,chassis_per_group=2,blades_per_chassis=8",
    "dragonfly": "dragonfly:p=2,a=8,h=4",
    "dragonfly_plus": "dragonfly_plus:p=4,a_leaf=8,a_spine=8,h=2,g=17",
}

#: the victim's candidate routing arms (the matrix columns)
ARMS = {
    "adaptive": RoutingMode.ADAPTIVE_0,
    "minimal": RoutingMode.ADAPTIVE_3,
    "app_aware": "app_aware",
}

#: fault scenarios, phase indices == ROUND indices.  Both clear before
#: the shortest pass ends (all_clear_phase == 6 < 8 rounds) so the
#: recovery fields are always numeric (schema contract).
CLEAR_ROUND = 6


def make_scenarios(seed: int) -> dict:
    """name -> FaultSchedule (deterministic in the benchmark seed)."""
    return {
        # two global links hard-down for rounds [2, 6)
        "link_down": FaultSchedule.of(
            link_down(start=2, end=CLEAR_ROUND, n_random=2,
                      link_kind="global", seed=seed)),
        # a flapping global link on top of two brown-out links at 30%
        # capacity, rounds [1, 6)
        "flap_degrade": FaultSchedule.of(
            link_flap(start=1, end=CLEAR_ROUND, period=2, duty=1,
                      n_random=1, link_kind="global", seed=seed + 1),
            link_degrade(0.3, start=1, end=CLEAR_ROUND, n_random=2,
                         link_kind="global", seed=seed + 2)),
        # two whole routers down for rounds [2, 6): their hosted nodes
        # lose their NIC links, stranding every flow that touches them
        # (the reroute-or-drop penalty shows up in stranded_flows)
        "router_down": FaultSchedule.of(
            router_down(start=2, end=CLEAR_ROUND, n_random=2,
                        seed=seed + 3)),
    }


def make_mix(scale: float = 1.0) -> TenancyMix:
    """The fixed job mix: a latency-sensitive stencil victim sharing
    the machine with one adaptive-heavy bulk-alltoall aggressor."""
    r = lambda n: max(8, int(n * scale))  # noqa: E731
    return TenancyMix("halo3d-vs-alltoall", (
        Workload("halo3d", "halo3d", r(64),
                 {"nx": 64, "var_bytes": 8, "vars_": 4}),
        Workload("alltoall", "alltoall", r(96),
                 {"size_per_pair": 8192},
                 arm=RoutingMode.ADAPTIVE_0)))


def run(rounds: int, scale: float, seed: int, out_path: str | None = None,
        topologies: dict | None = None, device=None):
    topologies = topologies or TOPOLOGIES
    # ambient background OFF for the same reason as the interference
    # matrix: the pareto bg draws would decorrelate the run-alone
    # baseline's RNG stream and drown the fault signal.
    params = SimParams(seed=seed, bg_enable=False)
    scenarios = make_scenarios(seed)
    mix = make_mix(scale)

    matrix: dict = {}
    for topo_label, topo_spec in topologies.items():
        for scen_name, sched in scenarios.items():
            key = f"{topo_label}|{scen_name}"
            for policy, arm in ARMS.items():
                cell_mix = mix.with_victim_arm(arm)
                eng = InterferenceEngine(topo_spec, params, seed=seed,
                                         device=device)
                res = eng.run_mix(cell_mix, rounds=rounds, faults=sched)
                vic = res.victim_report
                cell = {
                    "topology": topo_spec,
                    "scenario": scen_name,
                    "victim_slowdown": vic.slowdown,
                    "victim_time_us": vic.time_us,
                    "victim_alone_us": vic.alone_time_us,
                    "victim_recovery_rounds": vic.recovery_rounds,
                    "victim_recovery_time_us": vic.recovery_time_us,
                    "stranded_flows": vic.stranded_flows,
                    "tenant_recovery": {
                        t.name: {
                            "slowdown": t.slowdown,
                            "recovery_rounds": t.recovery_rounds,
                            "recovery_time_us": t.recovery_time_us,
                            "stranded_flows": t.stranded_flows,
                        } for t in res.tenants
                    },
                }
                matrix.setdefault(key, {})[policy] = cell
                emit(f"faults.{key}.{policy}", vic.time_us,
                     f"slowdown={vic.slowdown:.3f};"
                     f"rec={vic.recovery_rounds};"
                     f"stranded={vic.stranded_flows}")

    # qualitative checks: faults hurt (slowdown > 1 vs the clean
    # baseline) and policies come back once the schedule clears
    inflated = [k for k, row in matrix.items()
                if all(c["victim_slowdown"] > 1.0 for c in row.values())]
    recovered = [k for k, row in matrix.items()
                 if all(c["victim_recovery_rounds"] is not None
                        and c["victim_recovery_rounds"] >= 0
                        for c in row.values())]
    aa_wins = [k for k, row in matrix.items()
               if row["app_aware"]["victim_slowdown"]
               < row["adaptive"]["victim_slowdown"]]
    emit("faults.check.victims_inflated", len(inflated),
         f"{len(inflated)}/{len(matrix)} cells")
    emit("faults.check.all_policies_recover", len(recovered),
         f"{len(recovered)}/{len(matrix)} cells")
    emit("faults.check.app_aware_beats_adaptive", len(aa_wins),
         f"{len(aa_wins)}/{len(matrix)} cells")

    doc = {
        "schema": SCHEMA,
        "rounds": int(rounds),
        "seed": int(seed),
        "topologies": list(topologies.values()),
        "scenarios": {name: s.describe()
                      for name, s in scenarios.items()},
        "policies": list(ARMS),
        "matrix": matrix,
        "checks": {
            "victims_inflated_cells": inflated,
            "all_policies_recover_cells": recovered,
            "app_aware_beats_adaptive_cells": aa_wins,
        },
    }
    if out_path:
        pathlib.Path(out_path).write_text(json.dumps(doc, indent=2,
                                                     sort_keys=True) + "\n")
    return doc


def main(full: bool = False, smoke: bool = False,
         out: str | None = None, topology: str | None = None,
         device=None) -> dict:
    topos, rounds, scale = dict(TOPOLOGIES), 10, 1.0
    if smoke:
        # CI pass: shrunken mix, one machine, still past CLEAR_ROUND so
        # the recovery fields stay numeric
        topos, rounds, scale = {"aries": TOPOLOGIES["aries"]}, 8, 0.375
    if full:
        rounds = 12
    if topology:
        topos = {"custom": topology}
    return run(rounds, scale, seed=7, out_path=out, topologies=topos,
               device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small CI pass (shrunken mix, aries only)")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale pass (12 rounds)")
    ap.add_argument("--out", default=None,
                    help="output JSON path (default: write none)")
    ap.add_argument("--topology", default=None,
                    help="make_topology spec replacing the machine list "
                         "(default: aries + dragonfly + dragonfly_plus)")
    ap.add_argument("--device", default=None,
                    help="torch device of the simulators (default: the "
                         "CUDA card)")
    args = ap.parse_args()
    main(full=args.full, smoke=args.smoke, out=args.out,
         topology=args.topology, device=args.device)

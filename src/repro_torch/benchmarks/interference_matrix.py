"""Multi-tenant interference matrix -> BENCH_interference.json.

The repro_torch.tenancy deliverable: a (job-mix x victim-policy) grid on one
shared Dragonfly.  Every mix pairs a latency/bandwidth-sensitive VICTIM
with adaptive-heavy AGGRESSORS (fully-adaptive routing, the "bad
neighbor" of the paper's production traces); the sweep swaps the
victim's routing arm and scores its slowdown vs a run-alone baseline.

Qualitative reproduction targets (Kang et al.):
  * adaptive-heavy aggressors inflate victims (slowdown > 1 in the mix);
  * biasing the victim toward minimal routing (HIGH-BIAS) and the
    app-aware arm keep the victim closer to run-alone than leaving it
    fully adaptive — in at least one mix app_aware < adaptive.

The matrix also carries the topology axis (docs/topology.md): the last
mix re-runs the first on a Dragonfly+ machine via `TenancyMix.topology`,
and ``--topology`` swaps the default machine for every other row.

Counterpart of ``benchmarks/interference_matrix.py`` on the port's
simulator.  Every column (one mix, the three victim arms) runs in
lockstep on the card: one batched pipeline dispatch per round
(``repro_torch.tenancy.sweep``).  Emits the ``name,us_per_call,derived``
CSV rows all benchmarks print, and writes the bench_interference/v2
JSON document (every cell records the topology it ran on) only to
``--out``:

    PYTHONPATH=src python -m repro_torch.benchmarks.interference_matrix [--smoke | --full] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.benchmarks.common import emit
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import SimParams, make_topology
from repro_torch.tenancy import TenancyMix, Workload, sweep

SCHEMA = "bench_interference/v2"

#: the default machine (the paper-like Aries layout) and the non-Aries
#: probe row's machine (a Dragonfly+ big enough for the same mix)
DEFAULT_TOPOLOGY = "aries:n_groups=6,chassis_per_group=2," \
                   "blades_per_chassis=8"
DPLUS_TOPOLOGY = "dragonfly_plus:p=4,a_leaf=8,a_spine=8,h=2,g=17"

#: the victim's candidate routing arms (the matrix columns)
ARMS = {
    "adaptive": RoutingMode.ADAPTIVE_0,
    "minimal": RoutingMode.ADAPTIVE_3,
    "app_aware": "app_aware",
}


def make_mixes(scale: float = 1.0) -> list:
    """The matrix rows: three victim/aggressor job mixes.

    scale < 1 shrinks ranks for the CI smoke pass (the qualitative
    ordering is what the full pass asserts, not the smoke numbers).
    """
    r = lambda n: max(8, int(n * scale))  # noqa: E731
    a2a = dict(arm=RoutingMode.ADAPTIVE_0)
    return [
        # nearest-neighbor stencil vs one bulk alltoall aggressor
        TenancyMix("halo3d-vs-alltoall", (
            Workload("halo3d", "halo3d", r(64),
                     {"nx": 64, "var_bytes": 8, "vars_": 4}),
            Workload("alltoall", "alltoall", r(96),
                     {"size_per_pair": 8192}, **a2a))),
        # bandwidth-bound allreduce vs a skewed expert-parallel alltoall
        TenancyMix("allreduce-vs-moe", (
            Workload("allreduce", "allreduce", r(64),
                     {"elements": 262144}),
            Workload("moe", "moe_alltoall", r(96),
                     {"tokens_per_rank": 1024, "token_bytes": 2048},
                     **a2a))),
        # wavefront sweep vs TWO alltoall aggressors (K=3)
        TenancyMix("sweep3d-vs-2xalltoall", (
            Workload("sweep3d", "sweep3d", r(64),
                     {"nx": 256, "var_bytes": 64}),
            Workload("alltoall_a", "alltoall", r(64),
                     {"size_per_pair": 16384}, **a2a),
            Workload("alltoall_b", "alltoall", r(64),
                     {"size_per_pair": 16384}, **a2a))),
        # the topology axis: the first mix again, on a Dragonfly+ machine
        TenancyMix("halo3d-vs-alltoall@dplus", (
            Workload("halo3d", "halo3d", r(64),
                     {"nx": 64, "var_bytes": 8, "vars_": 4}),
            Workload("alltoall", "alltoall", r(96),
                     {"size_per_pair": 8192}, **a2a)),
            topology=DPLUS_TOPOLOGY),
    ]


def run(rounds: int, scale: float, seed: int, out_path: str | None = None,
        topology: str | None = None, device=None):
    topo = make_topology(topology or DEFAULT_TOPOLOGY)
    # ambient background OFF: the matrix isolates CO-TENANT interference
    # (the heavy-tailed ambient bg is a different noise source, measured
    # by fig3/fig4; its pareto draws would also decorrelate the run-alone
    # baseline's RNG stream and drown the co-tenant delta).
    params = SimParams(seed=seed, bg_enable=False)
    mixes = make_mixes(scale)
    records = sweep(topo, mixes, ARMS, params=params, rounds=rounds,
                    seed=seed, device=device)

    matrix: dict = {}
    for rec in records:
        cell = {
            "topology": rec["topology"],
            "victim_slowdown": rec["victim_slowdown"],
            "victim_time_us": rec["victim_time_us"],
            "victim_alone_us": rec["victim_alone_us"],
            "victim_nonmin_fraction": rec["victim_nonmin_fraction"],
            "aggressor_slowdowns": rec["aggressor_slowdowns"],
        }
        matrix.setdefault(rec["mix"], {})[rec["policy"]] = cell
        emit(f"interference.{rec['mix']}.{rec['policy']}",
             rec["victim_time_us"],
             f"slowdown={rec['victim_slowdown']:.3f};"
             f"nmf={rec['victim_nonmin_fraction']:.3f}")

    # qualitative checks (the Kang findings this matrix reproduces):
    # (1) adaptive-heavy aggressors inflate minimal-routed victims;
    # (2) the app-aware arm keeps the victim closer to run-alone than
    #     leaving it fully adaptive.
    inflated = [m for m, row in matrix.items()
                if row["minimal"]["victim_slowdown"] > 1.0]
    aa_wins = [m for m, row in matrix.items()
               if row["app_aware"]["victim_slowdown"]
               < row["adaptive"]["victim_slowdown"]]
    emit("interference.check.minimal_victims_inflated",
         len(inflated), f"{len(inflated)}/{len(matrix)} mixes")
    emit("interference.check.app_aware_beats_adaptive",
         len(aa_wins), f"{len(aa_wins)}/{len(matrix)} mixes")

    doc = {
        "schema": SCHEMA,
        "rounds": int(rounds),
        "seed": int(seed),
        "topology": topo.describe(),
        "mixes": [m.name for m in mixes],
        "policies": list(ARMS),
        "matrix": matrix,
        "checks": {
            "minimal_victims_inflated_mixes": inflated,
            "app_aware_beats_adaptive_mixes": aa_wins,
            "app_aware_beats_adaptive": bool(aa_wins),
        },
    }
    if out_path:
        pathlib.Path(out_path).write_text(json.dumps(doc, indent=2,
                                                     sort_keys=True) + "\n")
    return doc


def main(full: bool = False, smoke: bool = False,
         out: str | None = None, topology: str | None = None,
         device=None) -> dict:
    rounds, scale = (8, 1.0) if not smoke else (3, 0.375)
    if full:
        rounds, scale = 12, 1.0
    return run(rounds, scale, seed=7, out_path=out, topology=topology,
               device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small CI pass (shrunken mixes, 3 rounds)")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale pass (12 rounds)")
    ap.add_argument("--out", default=None,
                    help="output JSON path (default: write none)")
    ap.add_argument("--topology", default=None,
                    help="make_topology spec for the default machine "
                         "(mixes with their own topology keep it); "
                         f"default: {DEFAULT_TOPOLOGY}")
    ap.add_argument("--device", default=None,
                    help="torch device of the simulators (default: the "
                         "CUDA card)")
    args = ap.parse_args()
    main(full=args.full, smoke=args.smoke, out=args.out,
         topology=args.topology, device=args.device)

"""Shared helpers for the port's paper-reproduction benchmarks.

Counterpart of ``benchmarks/common.py``.  Every module prints
``name,us_per_call,derived`` CSV rows and can emit richer tables with
--full."""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.noise import qcd
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import (DragonflyTopology, TopologyParams,
                                   make_topology)

# "Piz-Daint-like" (large) and "Cori-like" (small) topologies for Fig 8/9
DAINT = TopologyParams(n_groups=12)
CORI = TopologyParams(n_groups=8)


def bench_topology(spec, fallback: TopologyParams):
    """Resolve a benchmark's --topology axis (docs/topology.md).

    spec None keeps the suite's canonical Aries machine (`fallback`);
    otherwise any make_topology spec ("dragonfly_plus:p=4,...", a
    registered name, or a Topology instance) swaps the machine out."""
    if spec is None:
        return DragonflyTopology(fallback)
    return make_topology(spec)


def group_spread(topo, k: int) -> str:
    """'groups:k' clamped to machines with fewer than k groups."""
    return f"groups:{min(k, topo.n_groups)}"


def emit(name: str, us: float, derived: str = "") -> None:
    print(f"{name},{us:.3f},{derived}")


def boxstats(xs) -> dict:
    xs = np.asarray(xs, dtype=np.float64)
    return {
        "median": float(np.median(xs)),
        "mean": float(xs.mean()),
        "q1": float(np.percentile(xs, 25)),
        "q3": float(np.percentile(xs, 75)),
        "p99": float(np.percentile(xs, 99)),
        "max": float(xs.max()),
        "qcd": qcd(xs),
    }


def cli(doc: str, policy: bool = True) -> argparse.Namespace:
    """The figure scripts' shared command line: --full, --device,
    --topology and (with an adaptive arm) --policy."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--full", action="store_true",
                    help="the paper-scale run (default: the reduced one)")
    ap.add_argument("--device", default=None,
                    help="torch device of the simulator (default: the "
                         "CUDA card)")
    ap.add_argument("--topology", default=None,
                    help="make_topology spec replacing the machine")
    if policy:
        ap.add_argument("--policy", default="app_aware",
                        choices=("app_aware", "eps_greedy", "static"))
    return ap.parse_args()


MODE_LABEL = {RoutingMode.ADAPTIVE_0: "default",
              RoutingMode.ADAPTIVE_1: "incmin",
              RoutingMode.ADAPTIVE_3: "highbias",
              "app_aware": "appaware",
              "eps_greedy": "epsgreedy",
              "notification": "notify",
              "static": "staticpol"}

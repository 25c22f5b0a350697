"""Fig. 7 — routing-mode impact on a 4 MiB ping-pong, intra- vs inter-group.

Reproduces: (a) intra-group ADAPTIVE beats HIGH BIAS via stalls (7a/7b);
(b) inter-group HIGH BIAS wins with lower/steadier latency while ADAPTIVE
wanders on phantom congestion (7c); (c) the Eq.(2) model estimate tracks
the measured times (7d).

Counterpart of ``benchmarks/fig7_routing_pingpong.py`` on the port's
simulator:

    PYTHONPATH=src python -m repro_torch.benchmarks.fig7_routing_pingpong [--full] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import (DAINT, bench_topology, boxstats,
                                           cli, emit)
from repro_torch.core.perf_model import predict_transmission_cycles
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import DragonflySimulator, SimParams
from repro_torch.dragonfly.topology import make_allocation
from repro_torch.dragonfly.traffic import pingpong, run_iteration_engine
from repro_torch.policy import PolicyEngine, StaticPolicy, TelemetryBus

SIZE = 4 << 20
MODES = (RoutingMode.ADAPTIVE_0, RoutingMode.ADAPTIVE_3)


def run(iters: int = 40, seeds: int = 4, topology=None, device=None):
    topo = bench_topology(topology, DAINT)
    out = {}
    for tier, label in (("inter_chassis", "intra_group"),
                        ("inter_groups", "inter_groups")):
        res = {m: {"t": [], "l": [], "s": [], "est": []} for m in MODES}
        for seed in range(seeds):
            sim = DragonflySimulator(topo, SimParams(seed=seed),
                                     device=device)
            al = make_allocation(topo, 2, spread=tier, seed=seed)
            # static arms through the same engine API as the adaptive
            # ones: StaticPolicy, one vectorized decide per phase
            engines = {m: PolicyEngine(
                StaticPolicy(m),
                bus=TelemetryBus(clock_ghz=sim.params.nic_clock_ghz))
                for m in MODES}
            for _ in range(iters):
                for m in MODES:              # §5: alternate per iteration
                    r = run_iteration_engine(
                        sim, al, pingpong(2, SIZE), engines[m],
                        site=f"pingpong.{tier}",
                        counter_read_overhead_us=0.0,
                        use_plans=True)   # identical rounds share a plan
                    res[m]["t"].append(r.time_us)
                    res[m]["l"].append(r.mean_latency_us)
                    res[m]["s"].append(r.mean_stalls)
                    est = predict_transmission_cycles(
                        SIZE, r.mean_latency_us * 1e3, r.mean_stalls) \
                        / 1e3 * 2  # both directions
                    res[m]["est"].append(est)
        out[label] = res
    return out


def main(full: bool = False, topology=None, device=None):
    res = run(iters=50 if full else 25, seeds=4 if full else 3,
              topology=topology, device=device)
    for tier, modes in res.items():
        for m, d in modes.items():
            name = "adaptive" if m is RoutingMode.ADAPTIVE_0 else "highbias"
            st = boxstats(d["t"])
            emit(f"fig7.{tier}.{name}.time", st["median"],
                 f"qcd={st['qcd']:.3f}")
            lat_cv = float(np.std(d["l"]) / max(np.mean(d["l"]), 1e-9))
            emit(f"fig7.{tier}.{name}.latency",
                 float(np.median(d["l"])), f"qcd={lat_cv:.3f}")
            emit(f"fig7.{tier}.{name}.stalls",
                 float(np.median(d["s"]) * 1e3), "milli_cycles_per_flit")
            emit(f"fig7.{tier}.{name}.model_estimate",
                 float(np.median(d["est"])), "eq2")
    intra = res["intra_group"]
    ok_a = (np.median(intra[RoutingMode.ADAPTIVE_0]["t"])
            < np.median(intra[RoutingMode.ADAPTIVE_3]["t"]))
    ok_b = (np.median(intra[RoutingMode.ADAPTIVE_0]["s"])
            < np.median(intra[RoutingMode.ADAPTIVE_3]["s"]))
    emit("fig7.check.intra_adaptive_wins_via_stalls",
         1.0 if (ok_a and ok_b) else 0.0, "")
    # model correlation (7d): estimates track measurements per mode/tier
    pairs = []
    for tier, modes in res.items():
        for m, d in modes.items():
            pairs.append((np.median(d["t"]), np.median(d["est"])))
    t, e = np.array(pairs).T
    corr = float(np.corrcoef(t, e)[0, 1]) if len(pairs) > 2 else 1.0
    emit("fig7.check.model_tracks_measurement", corr * 100, "pct_corr")
    return res


if __name__ == "__main__":
    args = cli(__doc__, policy=False)
    main(full=args.full, topology=args.topology, device=args.device)

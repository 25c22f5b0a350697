"""How far free runs of the simulator stay together.

Runs one seeded §5 sequence (halo3d on the golden tests' small machine,
ADAPTIVE and HIGH BIAS alternating per iteration, planned phases) three
times without any re-anchoring: the reference's float64 NumPy backend,
its float32 jax engine, and the port on the CPU (``--device cuda`` for
the card).  Prints, per phase, each float32 run's largest per-flow
relative ``t_us`` difference from NumPy, and each run's horizon: the
first phase where that difference exceeds the jax engine's
``JAX_RTOL = 2e-2``.  The queues and the stale-estimate memory carry
each phase's result into the next one's routing, so a difference grows
from phase to phase; this is why ``repro_torch.benchmarks.parity``
anchors long comparisons.

    PYTHONPATH=src python scripts/protocol_drift.py [--iters 6] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

JAX_RTOL = 2e-2
SMALL = "aries:n_groups=4,chassis_per_group=2,blades_per_chassis=4"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    import repro.dragonfly as ref
    from repro.core.strategies import RoutingMode as RefMode
    from repro.dragonfly.topology import make_allocation
    import repro_torch.dragonfly as port
    from repro_torch.core.strategies import RoutingMode as PortMode

    rtopo, ptopo = ref.make_topology(SMALL), port.make_topology(SMALL)
    sims = {
        "numpy": ref.DragonflySimulator(rtopo, ref.SimParams(seed=0)),
        "jax": ref.DragonflySimulator(rtopo, ref.SimParams(seed=0,
                                                          backend="jax")),
        "port": port.DragonflySimulator(ptopo, port.SimParams(seed=0),
                                        device=args.device),
    }
    alloc = make_allocation(rtopo, 64, spread="groups:4", seed=0)
    palloc = port.Allocation(alloc.allocation_id, alloc.nodes)
    nodes = np.asarray(alloc.nodes)
    phases = ref.PATTERNS["halo3d"](64, nx=256)
    horizon: dict = {}
    k = 0
    print("phase,mode,jax_max_rel_t_us,port_max_rel_t_us")
    for _ in range(args.iters):
        for mode in ("ADAPTIVE_0", "ADAPTIVE_3"):
            for s, d, b in phases:
                out = {}
                for name, sim in sims.items():
                    is_port = name == "port"
                    pol = (port if is_port else ref).RoutingPolicy(
                        (PortMode if is_port else RefMode)[mode])
                    plan = sim.plan_for(nodes[s], nodes[d], b)
                    out[name] = sim.run_phase(nodes[s], nodes[d], b, pol,
                                              palloc if is_port else alloc,
                                              plan=plan).t_us
                rel = {n: float(np.max(np.abs(out[n] - out["numpy"])
                                       / out["numpy"]))
                       for n in ("jax", "port")}
                for n, r in rel.items():
                    if r > JAX_RTOL:
                        horizon.setdefault(n, k)
                print(f"{k},{mode},{rel['jax']:.3e},{rel['port']:.3e}")
                k += 1
    for n in ("jax", "port"):
        print(f"horizon.{n},{horizon.get(n, 'none')},first phase past "
              f"rtol {JAX_RTOL} of {k}")


if __name__ == "__main__":
    main()

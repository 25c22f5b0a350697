"""Benchmark runner — one function per paper table or figure, on the
port's simulator.

Counterpart of ``benchmarks/run.py``, with its suites and flags plus
``--device`` (default: the CUDA card); the reference's ``tpu`` suite is
``selector`` here (:mod:`repro_torch.benchmarks.h100_selector`).  Prints
``name,us_per_call,derived`` CSV on stdout and each suite's wall time on
stderr.  ``--full`` runs the paper-scale sweeps (minutes); the default
is a reduced pass.  ``--topology`` swaps the machine of every suite that
takes one (all but ``selector`` and ``perf``).

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig7,fig8,selector
    PYTHONPATH=src python -m repro_torch.benchmarks.run --only selector,model --device cpu
"""

from __future__ import annotations

import argparse
import inspect
import sys
import time


def suites() -> dict:
    """The suite keys and their modules' ``main``."""
    from repro_torch.benchmarks import (fig3_allocation, fig4_fig5_hostnoise,
                                        fig7_routing_pingpong,
                                        fig8_microbench, fig10_applications,
                                        h100_selector, interference_matrix,
                                        model_validation, perf_sim,
                                        table1_correlation)
    return {
        "fig3": fig3_allocation.main,
        "table1": table1_correlation.main,
        "fig4fig5": fig4_fig5_hostnoise.main,
        "fig7": fig7_routing_pingpong.main,
        "fig8": fig8_microbench.main,
        "fig10": fig10_applications.main,
        "model": model_validation.main,
        "selector": h100_selector.main,
        "perf": perf_sim.main,
        "interference": interference_matrix.main,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset, e.g. fig3,fig7")
    ap.add_argument("--policy", default="app_aware",
                    choices=("static", "app_aware", "eps_greedy"),
                    help="adaptive arm of the policy-driven suites (fig8, "
                         "fig10): which repro_torch.policy engine runs "
                         "against the static Default/HIGH-BIAS arms")
    ap.add_argument("--topology", default=None,
                    help="make_topology spec swapping the machine, e.g. "
                         "'dragonfly_plus:p=4,a_leaf=8,a_spine=8,h=2,g=17' "
                         "(docs/topology.md)")
    ap.add_argument("--device", default=None,
                    help="torch device of the simulator (default: the CUDA "
                         "card)")
    args = ap.parse_args(argv)
    table = suites()
    chosen = args.only.split(",") if args.only else list(table)
    unknown = [key for key in chosen if key not in table]
    if unknown:
        ap.error(f"unknown suites {unknown}; known: {list(table)}")
    print("name,us_per_call,derived")
    for key in chosen:
        fn = table[key]
        takes = inspect.signature(fn).parameters
        kw = {name: val for name, val in (("policy", args.policy),
                                          ("topology", args.topology),
                                          ("device", args.device))
              if name in takes and val is not None}
        t0 = time.time()
        fn(full=args.full, **kw)
        print(f"# {key} done in {time.time() - t0:.1f}s", file=sys.stderr)


if __name__ == "__main__":
    main()

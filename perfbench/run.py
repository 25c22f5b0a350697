"""Runs one cell of ``BENCHMARK.json`` once on the CUDA card and prints
its result as the last line of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Set-up (``setup_s``) is timed from this script's start to the first
timed step.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, read by ``metrics/<name>.py`` from
the window and a profiler trace of ``trace_units`` more units.  The
numbers that decide ``correct`` are printed, each beside its limit, as
the last lines of standard error and under ``checks``, the last key of
the result.  The run fails, printing no result, without a CUDA card or
with fewer than the cell's chips, and if JAX or the JAX package
(``repro``) was loaded.  The port's kernel libraries are built in their
``build/`` folders inside the checkout; other kernel caches are kept in
``.perfbench_cache/`` at its root.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / ".perfbench_cache" / sub))
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "1")
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

#: top-level modules that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded() -> list:
    return sorted({name.split(".", 1)[0] for name in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] or None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def per_layer(cell, out: dict) -> dict:
    """The cell's per-layer metrics that their readers find."""
    from types import SimpleNamespace

    from perfbench import spec

    ctx = SimpleNamespace(model=cell.model, traffic=cell.traffic,
                          units=out["units"], window_s=out["window_s"],
                          trace=out["trace"],
                          trace_units=cell.traffic["trace_units"])
    got = {}
    for metric in cell.per_layer:
        value = spec.metric_reader(metric["name"])(ctx)
        if value is not None:
            got[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import profiling, spec

    cell = spec.load_cell(args.workload)
    import torch

    torch.set_num_threads(1)

    from perfbench.kinds import log
    log(f"torch imported at {time.perf_counter() - T_START:.3f} s")

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out = spec.kind(cell.traffic).run(cell, args.seed, args.seconds,
                                      bool(args.trace), dev, T_START)
    loaded = forbidden_loaded()
    if loaded:
        print(f"perfbench: modules loaded that the port may not use: "
              f"{loaded}", file=sys.stderr)
        return 3

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power_limit": power_limit()}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"]}
    if args.trace:
        trace = out["trace"]
        device.update(busy_s=profiling.busy_s(trace),
                      window_s=trace.window_s)
        result["metrics"] = per_layer(cell, out)
        result["device"] = device
        result["breakdown"] = profiling.breakdown(trace)
    else:
        want = [m["name"] for m in cell.end_to_end]
        missing = [n for n in want if n not in out["e2e"]]
        if missing:
            raise RuntimeError(f"{args.workload}: no reading of {missing}")
        result["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = device
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

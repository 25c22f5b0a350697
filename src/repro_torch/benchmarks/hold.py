"""Hold one benchmark JSON document against another: a matrix driver's
output on the card against the committed reference output
(``BENCH_{interference,faults,notifications}.json``).

    PYTHONPATH=src python -m repro_torch.benchmarks.hold GOT.json WANT.json [--skip PATH]

Floats (simulated times, slowdowns, fractions: not speed) are held at
the jax engine's ``JAX_RTOL``, everything else (integers, strings,
None, the ``checks`` lists) equal.  ``--skip`` takes dotted paths with
``*`` wildcards (``workloads``, ``workloads.*.notification_events``).
Prints every difference and the largest relative gap; exits 1 on a
difference.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import math
import sys

#: float32 pipelines vs float64 NumPy (tests/test_jax_engine.py)
JAX_RTOL = 2e-2


def differences(got, want, skip=(), path: str = "") -> tuple:
    """([difference, ...], largest relative gap of the floats held)."""
    if any(fnmatch.fnmatchcase(path, pat) for pat in skip):
        return [], 0.0
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            keys = sorted(got) if isinstance(got, dict) else got
            return [f"{path}: keys {keys} against {sorted(want)}"], 0.0
        out, worst = [], 0.0
        for k in want:
            d, w = differences(got[k], want[k], skip,
                               f"{path}.{k}" if path else str(k))
            out += d
            worst = max(worst, w)
        return out, worst
    if isinstance(want, float) and isinstance(got, (int, float)) \
            and not isinstance(got, bool):
        top = max(abs(want), abs(got))
        gap = abs(got - want) / top if top > 0 else 0.0
        if math.isnan(gap) or gap > JAX_RTOL:
            return [f"{path}: {got!r} against {want!r} (relative gap "
                    f"{gap:.3e} > {JAX_RTOL})"], gap
        return [], gap
    if isinstance(want, list) and isinstance(got, list) \
            and len(got) == len(want) \
            and any(isinstance(w, (dict, list, float)) for w in want):
        out, worst = [], 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            d, gap = differences(g, w, skip, f"{path}[{i}]")
            out += d
            worst = max(worst, gap)
        return out, worst
    if got != want:
        return [f"{path}: {got!r} against {want!r}"], 0.0
    return [], 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("got")
    ap.add_argument("want")
    ap.add_argument("--skip", action="append", default=[])
    args = ap.parse_args(argv)
    with open(args.got) as f:
        got = json.load(f)
    with open(args.want) as f:
        want = json.load(f)
    diffs, worst = differences(got, want, args.skip)
    for d in diffs:
        print("DIFFERS", d)
    print(f"{args.got} against {args.want}: {len(diffs)} differences, "
          f"largest relative gap held {worst:.3e} (rtol {JAX_RTOL})")
    return 1 if diffs else 0


if __name__ == "__main__":
    sys.exit(main())

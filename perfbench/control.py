"""The controls and the faults of a cell, read at the cell's own size on
the CUDA card; the benchmark's own runs do not run this.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--program [--seconds S]]

With ``--program`` it prints, for each seed, the numbers that a run of
the cell (``perfbench/run.py``'s driver, a window of ``S`` seconds,
long enough for a serve cell to finish its ``checked_batches``) reads
for the program, many seeds in one process: the lower readings that the
limits are set from.  Otherwise, for each seed it prints one JSON line
with the numbers that decide ``correct`` (``perfbench/judge.py``) read
for:

* ``fp8``: the plain reference put in the program's place and computed
  one precision below the configuration's bfloat16 (every matrix
  product on e4m3 operands, their gradients e5m2), against the float32
  reference: the control, which the limits have to fail;
* training only, ``half_batch``: the reference's steps on the first half
  of each batch's rows (the mean over the rest), the fault of a step
  that leaves half of the batch out.  A step that returns its state
  unchanged reads 1 as ``change_gap`` by definition;
* serving only, ``altered``: every served token replaced by the next id,
  the fault of a token altered where it is produced (``p05``: the 5th
  percentile of one altered token's gap).  The served tokens
  are the float32 reference's own greedy tokens (prefill, then one
  decode position a token), and fp8's gaps are those of the tokens it
  puts first at the same positions.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "perfbench"]
sys.path.insert(0, str(ROOT))


def train_control(cell, seed: int, dev) -> dict:
    from perfbench import judge
    from perfbench.kinds import train

    ref = train.readings(cell, seed, dev)
    out, losses = {}, {"f32": ref["losses"]}
    low = train.readings(cell, seed, dev, prec="fp8")
    out["fp8"] = judge.train_numbers(low, ref)
    out["fp8"]["worst"] = judge.worst_leaves(low, ref)
    losses["fp8"] = low["losses"]
    half = train.readings(cell, seed, dev,
                          rows=cell.traffic["batch"] // 2)
    out["half_batch"] = judge.train_numbers(half, ref)
    out["half_batch"]["worst"] = judge.worst_leaves(half, ref)
    losses["half_batch"] = half["losses"]
    return dict(out, losses=losses)


def serve_control(cell, seed: int, dev) -> dict:
    import torch

    from perfbench import judge, spec, weights
    from perfbench.kinds.serve import call_segments
    from perfbench.reference import common as C

    C.strict_f32()
    tr, m = cell.traffic, cell.model
    s, new, vocab = tr["seq_len"], tr["max_new_tokens"], m["vocab"]
    ref = spec.reference(m)
    params = weights.make(ref.param_shapes(m), seed, dev, cell.init)
    gen = spec.generator(tr)
    gaps = {"fp8": [], "altered": []}
    positions = range(s - 1, s + new - 1)
    for i in range(tr["checked_batches"]):
        toks = torch.from_numpy(gen.draw(tr, vocab, seed, i)["tokens"]) \
            .long().to(dev)
        for t in range(new - 1):   # the float32 reference's greedy tokens
            lg = ref.logits_at(params, toks, m, "f32", [toks.shape[1] - 1],
                               call_segments(s, t + 1))
            toks = torch.cat([toks, lg[:, -1, :vocab].argmax(-1)[:, None]],
                             1)
        lg = ref.logits_at(params, toks, m, "f32", positions,
                           call_segments(s, new))
        served = lg[..., :vocab].argmax(-1)
        gaps["altered"].append(judge.logit_gaps(lg, (served + 1) % vocab,
                                                vocab).flatten())
        low = ref.logits_at(params, toks, m, "fp8", positions,
                            call_segments(s, new))
        gaps["fp8"].append(judge.logit_gaps(
            lg, low[..., :vocab].argmax(-1), vocab).flatten())
    out = {k: judge.serve_numbers(torch.cat(v)) for k, v in gaps.items()}
    out["altered"]["p05"] = float(torch.cat(gaps["altered"]).quantile(0.05))
    return out


def program_readings(cell, seed: int, dev, seconds: float) -> dict:
    """The numbers compared in a run of the cell with a window of
    ``seconds`` (a serve cell's has to finish its ``checked_batches``)."""
    from perfbench import spec

    out = spec.kind(cell.traffic).run(cell, seed, seconds, False, dev,
                                      time.perf_counter())
    return {k: c["value"] for k, c in out["checks"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--program", action="store_true",
                    help="the program's readings, not the controls'")
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="with --program: the window of each run")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from perfbench import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    run = train_control if cell.traffic["kind"] == "train" \
        else serve_control
    if args.program:
        run = functools.partial(program_readings, seconds=args.seconds)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run(cell, seed, dev)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

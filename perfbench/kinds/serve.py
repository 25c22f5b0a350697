"""A serve mix: a closed loop of the port's ``ServeEngine.run``, the next
batch sent when the last one returns.

Set-up builds the model on the device from the seed, the engine (its
``comm_policy`` routing each batch's KV transfer), draws a pool of
prompt batches from the seed and serves one more batch of the same
shape to warm up.  The window serves batches for ``seconds``,
synchronised at its end; with ``trace``, ``trace_units`` more batches
run under the profiler once it has closed.  Once the program's state is
freed, a sample of the window's batches drawn from the seed is run
through the plain reference, prompt and served tokens, each call's
positions grouped as the port's call grouped them, and every served
token's logit is held against the reference's best at its position.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import judge, profiling, spec, weights
from perfbench.kinds import (Marks, build_model, free, log, now,
                             peak_bytes, prebuild, reset_peak, sync)


def run(cell, seed: int, seconds: float, trace: bool, dev: torch.device,
        t_start: float, engine_hook=None) -> dict:
    """One run of the cell; ``engine_hook(engine)`` may break the
    engine's timed path (the tests' faults)."""
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    tr, m = cell.traffic, cell.model
    b, s, new = tr["batch"], tr["seq_len"], tr["max_new_tokens"]
    log(f"the port imported at {now() - t_start:.3f} s")
    reset_peak(dev)
    log(f"imports and the device at {now() - t_start:.3f} s")
    prebuild(dev)
    log(f"kernel libraries at {now() - t_start:.3f} s")
    cfg, model = build_model(cell, seed, dev)
    engine = ServeEngine(cfg, model, ServeConfig(
        batch=b, max_len=s + new, comm_policy=tr["comm_policy"]),
        device=dev)
    if engine_hook is not None:
        engine_hook(engine)
    gen = spec.generator(tr)
    prompts = [gen.draw(tr, m["vocab"], seed, i)["tokens"].tolist()
               for i in range(tr["pool"] + 1)]

    def serve(rows: list) -> list:
        reqs = engine.run([Request(prompt=p, max_new_tokens=new)
                           for p in rows], seed=seed)
        return [list(r.out_tokens) for r in reqs]

    log(f"model, weights and {len(prompts)} batches at "
        f"{now() - t_start:.3f} s")
    serve(prompts[-1])
    sync(dev)
    setup_s = now() - t_start
    log(f"set-up {setup_s:.3f} s")

    marks = Marks(dev)
    served, t0 = [], now()
    marks.mark()
    while True:
        served.append(serve(prompts[len(served) % tr["pool"]]))
        marks.mark()
        if now() - t0 >= seconds:
            break
    sync(dev)
    window_s = now() - t0
    memory = peak_bytes(dev)
    n = len(served)
    log(f"window {window_s:.3f} s, {n} batches, peak {memory} B")
    log(f"window's batches: {marks.summary()}")

    traced = None
    if trace:
        t_tr = now()
        traced = profiling.traced(
            lambda: [serve(prompts[(n + j) % tr["pool"]])
                     for j in range(tr["trace_units"])],
            lambda: sync(dev))
        log(f"traced {tr['trace_units']} batches in {now() - t_tr:.3f} s, "
            f"{len(traced.device)} device operations")
    del engine, model
    free(dev)

    tokens = sum(len(p) + len(o) for i, outs in enumerate(served)
                 for p, o in zip(prompts[i % tr["pool"]], outs))
    failed = sum(len(o) != new for outs in served for o in outs)
    t_ref = now()
    numbers = judge.serve_numbers(
        reference_gaps(cell, seed, dev, prompts, served) if not failed
        else torch.tensor([float("inf")]))
    log(f"reference {now() - t_ref:.3f} s, {numbers}")
    checks = judge.checks(numbers, cell.limits)
    return {"correct": judge.passed(checks) and not failed,
            "attempted": n * b, "failed": failed, "checks": checks,
            "memory_peak_bytes": memory,
            "e2e": {"setup_s": setup_s,
                    "serve_tokens_per_s": tokens / window_s,
                    "peak_mem_gib": memory / 2 ** 30},
            "units": n, "window_s": window_s, "trace": traced}


def sample(seed: int, n: int, pool: int, k: int) -> list:
    """The window batches the comparison reads: ``k`` of the first
    ``min(n, pool)`` (distinct prompts), drawn from the seed."""
    have = min(n, pool)
    rng = np.random.default_rng([int(seed), 17])
    return sorted(rng.choice(have, size=min(k, have), replace=False)
                  .tolist())


def call_segments(s: int, new: int) -> list:
    """The positions of the engine's calls for a prompt of ``s`` and
    ``new`` tokens: the prefill, then one decode step a token."""
    return [(0, s)] + [(s + t, s + t + 1) for t in range(new - 1)]


def reference_gaps(cell, seed: int, dev: torch.device, prompts: list,
                   served: list, prec: str = "f32") -> torch.Tensor:
    """The logit gap of each served token of the sampled batches."""
    from perfbench.reference import common as C

    C.strict_f32()
    tr, m = cell.traffic, cell.model
    s, new = tr["seq_len"], tr["max_new_tokens"]
    ref = spec.reference(m)
    params = weights.make(ref.param_shapes(m), seed, dev, cell.init)
    gaps = []
    for i in sample(seed, len(served), tr["pool"], tr["checked_batches"]):
        out = torch.tensor(served[i], dtype=torch.int64, device=dev)
        toks = torch.cat([torch.tensor(prompts[i], dtype=torch.int64,
                                       device=dev), out[:, :new - 1]], 1)
        logits = ref.logits_at(params, toks, m, prec,
                               range(s - 1, s + new - 1),
                               call_segments(s, new))
        gaps.append(judge.logit_gaps(logits, out, m["vocab"]).flatten())
    del params
    free(dev)
    return torch.cat(gaps).cpu()

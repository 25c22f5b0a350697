"""A train mix: AdamW steps through the port's ``train_step``, back to
back, with ``launch/train.py``'s ``decide_grad_schedule`` (Algorithm 1
over the gradient buckets) before each step, as ``train_loop`` runs
them.

Set-up builds the model with its module constructor on the device,
fills it from the seed, draws a pool of batches from the seed onto the
device, and drives the first ``checked_steps`` steps through the
window's own call and feed, reading what the comparison needs: each
step's loss, the first step's gradient as the optimizer got it (from its
moment after one step) and each leaf's change over the checked steps.
The window then runs steps for ``seconds``, synchronised at its end.
With ``trace``, ``trace_units`` more steps run under the profiler once
the window has closed.  Once the program's state is freed, the plain
reference follows the checked steps from the same weights and batches.
"""

from __future__ import annotations

import torch

from perfbench import judge, profiling, spec, weights
from perfbench.kinds import (Marks, build_model, free, log, now,
                             peak_bytes, prebuild, reset_peak, sync)


def _norm(t: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(t, dtype=torch.float64)


def run(cell, seed: int, seconds: float, trace: bool, dev: torch.device,
        t_start: float, step_fn=None) -> dict:
    """One run of the cell; ``step_fn`` stands in for the port's
    ``train_step`` (the tests' faults)."""
    from repro_torch.launch.train import (decide_grad_schedule,
                                          make_comm_engine)
    from repro_torch.train.grad_comm import (GradCommConfig,
                                             bucket_bytes_on_wire)
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import TrainConfig, train_step

    step_fn = step_fn or train_step
    tr, m = cell.traffic, cell.model
    log(f"the port imported at {now() - t_start:.3f} s")
    reset_peak(dev)
    log(f"imports and the device at {now() - t_start:.3f} s")
    prebuild(dev)
    log(f"kernel libraries at {now() - t_start:.3f} s")
    cfg, model = build_model(cell, seed, dev)
    params = dict(model.named_parameters())
    tcfg = TrainConfig(optimizer=AdamWConfig(**tr["optimizer"]),
                       z_loss=tr["z_loss"])
    gen = spec.generator(tr)
    pool = [{k: torch.from_numpy(v).to(dev)
             for k, v in gen.draw(tr, m["vocab"], seed, i).items()}
            for i in range(tr["pool"])]
    engine, cost_model = make_comm_engine(tr["comm_policy"])
    buckets = bucket_bytes_on_wire(params, GradCommConfig())
    state = {"opt": adamw_init(params)}
    log(f"model, weights and {len(pool)} batches at "
        f"{now() - t_start:.3f} s")

    def step(i: int) -> dict:
        decide_grad_schedule(engine, cost_model, buckets)
        _, state["opt"], metrics = step_fn(model, state["opt"],
                                           pool[i % len(pool)], cfg=cfg,
                                           tcfg=tcfg)
        return metrics

    checked = tr["checked_steps"]
    losses, first = [], None
    for i in range(checked):
        losses.append(step(i)["loss"])
        if i == 0:
            b1 = tr["optimizer"]["b1"]
            first = {n: _norm(t) / (1.0 - b1)
                     for n, t in state["opt"].m.items()}
    prog = {"losses": [float(x) for x in losses],
            "grad_norms": {n: float(v) for n, v in first.items()},
            "change_norms": weights.change_norms(params, seed, cell.init)}
    sync(dev)
    setup_s = now() - t_start
    log(f"set-up {setup_s:.3f} s, losses {prog['losses']}")

    marks = Marks(dev)
    t0, n = now(), 0
    marks.mark()
    while True:
        step(checked + n)
        marks.mark()
        n += 1
        if now() - t0 >= seconds:
            break
    sync(dev)
    window_s = now() - t0
    memory = peak_bytes(dev)
    log(f"window {window_s:.3f} s, {n} steps, peak {memory} B")
    log(f"window's steps: {marks.summary()}")

    traced = None
    if trace:
        base = checked + n
        t_tr = now()
        traced = profiling.traced(
            lambda: [step(base + j) for j in range(tr["trace_units"])],
            lambda: sync(dev))
        log(f"traced {tr['trace_units']} steps in {now() - t_tr:.3f} s, "
            f"{len(traced.device)} device operations")
    del model, params, pool, state, step
    free(dev)

    t_ref = now()
    ref = readings(cell, seed, dev)
    log(f"reference {now() - t_ref:.3f} s, losses {ref['losses']}")
    numbers = judge.train_numbers(prog, ref)
    log(f"worst leaves {judge.worst_leaves(prog, ref)}")
    checks = judge.checks(numbers, cell.limits)
    tokens = n * tr["batch"] * tr["seq_len"]
    return {"correct": judge.passed(checks), "attempted": n, "failed": 0,
            "checks": checks, "memory_peak_bytes": memory,
            "e2e": {"setup_s": setup_s, "train_tokens_per_s":
                    tokens / window_s,
                    "peak_mem_gib": memory / 2 ** 30},
            "units": n, "window_s": window_s, "trace": traced}


def readings(cell, seed: int, dev: torch.device, prec: str = "f32",
             rows: int = 0) -> dict:
    """The plain reference's readings of the checked steps, from the
    seed's weights and batches; ``rows``: the first rows of each batch
    only (0: all), the fault of a step that leaves half the batch out."""
    from perfbench.reference import common as C

    C.strict_f32()
    tr, m = cell.traffic, cell.model
    ref = spec.reference(m)
    params = weights.make(ref.param_shapes(m), seed, dev, cell.init)
    gen = spec.generator(tr)
    batches = []
    for i in range(tr["checked_steps"]):
        b = gen.draw(tr, m["vocab"], seed, i)
        t = torch.from_numpy(b["tokens"]).to(dev)
        lab = torch.from_numpy(b["labels"]).to(dev)
        batches.append((t[:rows], lab[:rows]) if rows else (t, lab))
    out = C.train_readings(
        lambda p, t, lab: ref.train_loss(p, t, lab, m, prec, tr["z_loss"]),
        params, batches, tr["optimizer"])
    out["change_norms"] = weights.change_norms(params, seed, cell.init)
    del params
    free(dev)
    return out

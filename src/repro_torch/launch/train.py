"""Training launcher: AdamW steps of every family with checkpoint and
restart, a straggler watch and Algorithm 1 over the gradient buckets.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --batch 8 --seq 512 --steps 8                      # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --batch 8 --seq 512 --steps 8                      # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-large-v3 \
        --batch 8 --seq 448 --steps 8                      # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --smoke --steps 6 --batch 2 --seq 32 --device cpu \
        --comm-policy app_aware                            # on the CPU

Counterpart of ``repro/launch/train.py``, with its flags plus
``--device`` (default: the CUDA card; without one the launcher raises).
The weights are random, drawn from ``--seed`` by the port's own
initialiser; the batches are the reference's ``SyntheticLM`` stream,
bit for bit, and an enc-dec or VLM batch carries the reference's stub
frame or patch embeddings, drawn from the seed and the step as it draws
them.  Every family trains, and every kernel of their forwards, B2, B3
and B4, has a backward kernel: the dense family (qwen2-1.5b,
stablelm-1.6b, llama3-8b, codeqwen1.5-7b), the SSM family
(mamba2-130m), the MoE family (granite-moe-3b-a800m, qwen2-moe-a2.7b;
the loss adds ``router_aux_coef`` times the layers' summed
load-balancing loss), the hybrid family (zamba2-7b), the enc-dec family
(whisper-large-v3: B2 non-causal over the 1504 frames, causal over the
tokens and across to the frames) and the VLM family (paligemma-3b: B2
at head dim 256 under the prefix-LM mask).  On one H100 80 GB, the
float32 masters, gradients and AdamW moments of zamba2-7b and of
granite-moe-3b-a800m at full depth, with a step's activations, exceed
the card.  ``--comm-policy`` runs Algorithm 1 over the gradient buckets
each step, on the cost model's self-fed telemetry, as the reference
does on one host; the decisions parameterise no reduce on one card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.collectives.modes import CollectiveMode
from repro_torch.collectives.selector import ICICostModel, MeshSpec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import registry as model_registry
from repro_torch.models.common import Family
from repro_torch.policy import POLICY_NAMES, DecisionBatch, make_engine
from repro_torch.runtime import resolve_device
from repro_torch.runtime.straggler import StragglerMitigator
from repro_torch.train.grad_comm import (GradCommConfig,
                                         bucket_bytes_on_wire)
from repro_torch.train.optimizer import AdamWConfig, AdamWState, adamw_init
from repro_torch.train.train_step import TrainConfig, train_step


def make_comm_engine(name: str, *, n_pods: int = 2, inner_chips: int = 256):
    """PolicyEngine arbitrating DIRECT vs HIERARCHICAL grad-reduce
    schedules for the training loop, and the cost model (the port's
    ``H100`` figures) that self-feeds its telemetry."""
    cost_model = ICICostModel(MeshSpec(n_pods=n_pods,
                                       inner_chips=inner_chips))
    # "message" granularity: every bucket row is its own Algorithm-1
    # step (matching grad_comm.select_bucket_modes), not one decision
    # stamped across the whole step's buckets
    engine = make_engine(name, mode_a=CollectiveMode.HIERARCHICAL,
                         mode_b=CollectiveMode.DIRECT,
                         mode_a_alltoall=CollectiveMode.HIERARCHICAL,
                         static_mode=CollectiveMode.DIRECT,
                         granularity="message")
    return engine, cost_model


def decide_grad_schedule(engine, cost_model, bucket_bytes: list):
    """One vectorized decision per step over all gradient buckets."""
    modes = engine.decide(DecisionBatch.of(bucket_bytes, site="grad_comm"))
    perfs = [cost_model.predict(int(sz), m)
             for sz, m in zip(bucket_bytes, modes)]
    engine.bus.publish_flow_arrays(
        [p.latency_cycles / 1e3 for p in perfs],
        [p.stall_cycles_per_flit for p in perfs], source="model")
    return modes


def make_batch_np(cfg, gen, *, step: int, batch: int, seed: int):
    """Step ``step``'s batch of ``SyntheticLM`` tokens and labels, plus
    the enc-dec family's stub frames ``[B, encoder_frames, D]`` or the
    VLM's stub patches ``[B, img_tokens, D]``, N(0, 0.02^2) from the seed
    and the step, as the reference's launcher draws them."""
    b = gen.batch(seed=seed, step=step, shard=0, n_shards=1,
                  batch_size=batch)
    rng = np.random.default_rng([seed, step, 99])
    if cfg.family == Family.ENCDEC:
        b["frames"] = rng.standard_normal(
            (batch, cfg.encoder_frames, cfg.d_model)).astype(np.float32) \
            * 0.02
    if cfg.family == Family.VLM:
        b["patches"] = rng.standard_normal(
            (batch, cfg.img_tokens, cfg.d_model)).astype(np.float32) * 0.02
    return b


def _restore(mgr, params: dict, opt: AdamWState) -> tuple:
    """Copies the latest checkpoint into ``params`` and ``opt``'s moments
    in place; returns (opt, step)."""
    (p_host, o_host), start, _ = mgr.restore((params, opt))
    with torch.no_grad():
        for src, dst in ((p_host, params), (o_host.m, opt.m),
                         (o_host.v, opt.v)):
            for name, t in dst.items():
                t.copy_(torch.from_numpy(src[name]))
    return opt._replace(step=int(o_host.step)), start


def train_loop(cfg, *, steps: int, batch: int, seq: int, seed: int,
               ckpt_dir: str | None, ckpt_every: int, lr: float,
               resume: bool = True, log_every: int = 10,
               comm_policy: str | None = None, device=None,
               history: list | None = None):
    """Trains ``cfg`` from ``seed`` for ``steps`` steps of ``batch`` x
    ``seq`` tokens on ``device`` -> (model, opt_state, losses).  Given a
    list, ``history`` gets one dict a step: ``loss``, ``aux`` (the MoE
    family's summed load-balancing loss, else 0), ``lr``, ``grad_norm``,
    ``step_s`` (host wall, synchronised, the batch's draw included) and
    the bucket ``modes`` Algorithm 1 chose."""
    dev = resolve_device(device)
    gen = SyntheticLM(vocab=cfg.vocab, seq_len=seq)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=lr, warmup_steps=max(
        steps // 20, 5), total_steps=steps))
    model = model_registry.init_params(cfg, seed, dev)
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    print(f"[train] {cfg.name}: "
          f"{sum(p.numel() for p in params.values()):,d} params on {dev}")
    start = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume and mgr.latest_step() is not None:
        opt, start = _restore(mgr, params, opt)
        model._cw = None
        print(f"[train] resumed from step {start}")

    strag = StragglerMitigator(n_workers=1)
    comm_engine = cost_model = None
    bucket_bytes: list = []
    if comm_policy:
        comm_engine, cost_model = make_comm_engine(comm_policy)
        bucket_bytes = bucket_bytes_on_wire(params, GradCommConfig())
        print(f"[train] comm policy '{comm_policy}': "
              f"{len(bucket_bytes)} grad buckets/step")
    losses = []
    for step in range(start, steps):
        t0 = time.perf_counter()
        b = make_batch_np(cfg, gen, step=step, batch=batch, seed=seed)
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        modes = []
        if comm_engine is not None:
            modes = decide_grad_schedule(comm_engine, cost_model,
                                         bucket_bytes)
        model, opt, metrics = train_step(model, opt, b, cfg=cfg, tcfg=tcfg)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        strag.record_step({0: dt})
        losses.append(loss)
        if history is not None:
            history.append({"step": step, "loss": loss,
                            "aux": float(metrics["aux"]),
                            "lr": float(metrics["lr"]), "grad_norm": gnorm,
                            "step_s": dt, "modes": [m.name for m in modes]})
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {gnorm:7.3f} {dt*1e3:6.0f}ms")
        if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
            mgr.save_async(step + 1, (params, opt),
                           meta={"loss": loss, "arch": cfg.name})
    if mgr:
        mgr.wait()
        mgr.save_async(steps, (params, opt), meta={"arch": cfg.name})
        mgr.wait()
    if comm_engine is not None:
        frac = comm_engine.traffic_fraction(CollectiveMode.HIERARCHICAL)
        print(f"[train] comm policy: {comm_engine.decide_calls} engine "
              f"calls, {comm_engine.rows_decided} bucket decisions, "
              f"{frac * 100:.0f}% bytes hierarchical")
    return model, opt, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--comm-policy", default=None, choices=POLICY_NAMES,
                    help="grad-reduce schedule policy (repro_torch.policy)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    _, _, losses = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        seed=args.seed, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        lr=args.lr, comm_policy=args.comm_policy, device=args.device)
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()

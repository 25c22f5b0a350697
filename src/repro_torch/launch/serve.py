"""Serving launcher: batched generation with the port's ServeEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --requests 8 --prompt-len 512 --new-tokens 32      # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --device cpu                               # on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m --requests 8 --prompt-len 512 \
        --new-tokens 32                                    # MoE, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --requests 8 --prompt-len 512 --new-tokens 32      # hybrid, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-large-v3 --requests 8 --prompt-len 128 \
        --new-tokens 32                                    # enc-dec, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \
        --requests 8 --prompt-len 512 --new-tokens 32      # VLM, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --requests 8 --prompt-len 512 --new-tokens 32      # also stablelm-1.6b,
                                                           # codeqwen1.5-7b

``--arch`` takes any ported architecture (``repro_torch.configs.PORTED``:
mamba2-130m, the dense qwen2-1.5b, stablelm-1.6b, llama3-8b,
codeqwen1.5-7b, the MoE granite-moe-3b-a800m and qwen2-moe-a2.7b, the
hybrid zamba2-7b, the enc-dec whisper-large-v3 and the VLM paligemma-3b).
qwen2-moe-a2.7b's 14.3 B parameters do not fit one 80 GB card as the
launcher builds them, in float32 masters (57.3 GB) plus their bf16 copies
(28.6 GB).  Served from bf16 parameters they do (47.8 GB reckoned with
the compute copies; chip_smoke.py phase 42), with the same bits: the weights
are drawn in float32 and cast, so the model holds the float32 masters'
bf16 copy, and the MoE router stays float32.  The launcher has no flag
for it; from the library::

    cfg = get_config("qwen2-moe-a2.7b").scaled(param_dtype=torch.bfloat16)
    model = model_registry.init_params(cfg, seed)          # on the card
    ServeEngine(cfg, model, ServeConfig(batch=8, max_len=552)).run(reqs)

The same holds for the dense family.  The weights are random, drawn from
``--seed``; for whisper the frame embeddings ``[requests,
encoder_frames, d_model]`` and for paligemma the patch embeddings
``[requests, img_tokens, d_model]`` are ``standard_normal * 0.02`` from
the same generator, after the prompts, as the reference's launcher draws
them, so a seed gives both packages the same inputs.  The VLM's
``max_len`` holds its ``img_tokens`` too.
``--device`` defaults to the CUDA card; without one the launcher raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import registry as model_registry
from repro_torch.models.common import Family
from repro_torch.runtime import resolve_device
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = model_registry.init_params(cfg, args.seed, device)
    scfg = ServeConfig(batch=args.requests,
                       max_len=args.prompt_len + args.new_tokens
                       + (cfg.img_tokens if cfg.family == Family.VLM else 0)
                       + 8)
    engine = ServeEngine(cfg, model, scfg, device=device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=list(rng.integers(1, cfg.vocab,
                                             args.prompt_len)),
                    max_new_tokens=args.new_tokens)
            for _ in range(args.requests)]
    extra = {}
    if cfg.family == Family.ENCDEC:
        extra["frames"] = rng.standard_normal(
            (args.requests, cfg.encoder_frames, cfg.d_model)
        ).astype(np.float32) * 0.02
    if cfg.family == Family.VLM:
        extra["patches"] = rng.standard_normal(
            (args.requests, cfg.img_tokens, cfg.d_model)
        ).astype(np.float32) * 0.02
    t0 = time.perf_counter()
    out = engine.run(reqs, seed=args.seed, extra=extra or None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    total_new = sum(len(r.out_tokens) for r in out[:args.requests])
    print(f"[serve] {cfg.name} on {where}: {args.requests} requests, "
          f"{total_new} tokens in {dt:.2f}s "
          f"({total_new / max(dt, 1e-9):.1f} tok/s)")
    for i, r in enumerate(out[: min(3, args.requests)]):
        print(f"  req{i}: {r.out_tokens[:12]}...")
    return out


if __name__ == "__main__":
    main()

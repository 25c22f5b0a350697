"""How far one float32 train step moves when only the summation order
changes, beside how far the card is from the CPU.

One float32 step (``value_and_grad`` and AdamW, chip_smoke's phase-25
optimizer: lr 1e-3 after a one-step warm-up) of a port config at full
width and a cut depth, from the same weights and batch, three times: on
the card, on the CPU with one thread, and on the CPU with all its
threads.  The two CPU runs differ only in how their float32 sums are
split, so their gap is a floor for the card's.  For each pair (card
against CPU, one thread against all) it prints the loss and gradient
norm, the tensors with the largest gradient gaps (relative to each
tensor's largest entry), and the entries with the largest updated-
parameter gaps among those chip_smoke's sign rule would take without
its eps condition (|g| above 1e-3 of the tensor's largest), with their
two gradients and the clip scale.

    python scripts/train_f32_spread.py [--arch zamba2-7b] [--layers 3]
        [--period 1] [--top 6]

Needs a CUDA device; the CPU runs hold the model's masters, gradients
and AdamW moments in host memory (about 16 bytes a parameter each).
"""

from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import libraries  # noqa: E402
from repro_torch.kernels._build import build_all  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.common import Family  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,  # noqa: E402
                                         adamw_update)
from repro_torch.train.train_step import TrainConfig, value_and_grad  # noqa: E402

BATCH, SEQ, SEED = 2, 64, 0
SIGN_FLOOR = 1e-3


def step(host, cfg, batch, tcfg, device, threads: int) -> tuple:
    """(loss, grad norm, gradients, updated parameters), float64 on the
    host, of one step of a copy of ``host`` on ``device``."""
    torch.set_num_threads(threads)
    model = copy.deepcopy(host).to(device)
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    loss, _, grads = value_and_grad(model, b, cfg, tcfg)
    g = {k: v.detach().cpu().double() for k, v in grads.items()}
    params = dict(model.named_parameters())
    _, _, m = adamw_update(tcfg.optimizer, params, grads, adamw_init(params))
    return (float(loss), float(m["grad_norm"]), g,
            {k: p.detach().cpu().double() for k, p in params.items()})


def compare(label: str, a: tuple, b: tuple, top: int) -> None:
    (la, na, ga, pa), (lb, nb, gb, pb) = a, b
    print(f"== {label}: loss {la:.9g} / {lb:.9g}, grad norm {na:.9g} / "
          f"{nb:.9g}, clip scale {min(1.0, 1.0 / nb):.4e}")
    rows = []
    for k, g in gb.items():
        big = float(g.abs().max())
        sign = g.abs() > SIGN_FLOOR * big
        gap = torch.where(sign, (pa[k] - pb[k]).abs(), 0.0)
        at = int(gap.argmax())
        rows.append((float((ga[k] - g).abs().max()) / big if big else 0.0,
                     k, big, float(gap.flatten()[at]),
                     float(ga[k].flatten()[at]), float(g.flatten()[at])))
    rows.sort(reverse=True)
    for gg, k, big, _, _, _ in rows[:top]:
        print(f"  gradient gap {gg:.3e} of the largest |g| {big:.3e}: {k}")
    rows.sort(key=lambda r: -r[3])
    for _, k, big, pg, g1, g2 in rows[:top]:
        print(f"  updated-parameter gap {pg:.3e} at g {g1:.6e} / {g2:.6e} "
              f"(largest |g| {big:.3e}): {k}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--period", type=int, default=1,
                    help="shared_attn_period (hybrid configs only)")
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_f32_spread: needs a CUDA device", file=sys.stderr)
        return 2
    libs = libraries()
    build_all(libs)
    for lib in libs:
        lib.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cut = {"n_layers": args.layers}
    base = get_config(args.arch)
    if base.family == Family.HYBRID:
        cut["shared_attn_period"] = args.period
    cfg = base.scaled(dtype=torch.float32, **cut)
    print(f"{cfg.name} at full width, {cut}, {BATCH} x {SEQ} tokens, "
          f"float32; {torch.cuda.get_device_name(0)}")
    host = registry.init_params(cfg, SEED, "cpu")
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ).batch(
        seed=SEED, step=0, shard=0, n_shards=1, batch_size=BATCH)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1,
                                             total_steps=8))
    threads = torch.get_num_threads()
    card = step(host, cfg, batch, tcfg, torch.device("cuda"), threads)
    one = step(host, cfg, batch, tcfg, torch.device("cpu"), 1)
    every = step(host, cfg, batch, tcfg, torch.device("cpu"), threads)
    compare(f"card / CPU ({threads} threads)", card, every, args.top)
    compare(f"CPU 1 thread / CPU {threads} threads", one, every, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())

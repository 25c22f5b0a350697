"""End-to-end training example.

Default: a ~15M-parameter dense LM (``demo-15m``) for 200 steps on
synthetic data with checkpointing.  ``--arch``/``--full`` select any of
the 10 architectures (e.g. the true 130M mamba2).  Counterpart of
``examples/train_lm.py``:

    PYTHONPATH=src python -m repro_torch.examples.train_lm            # ~15M dense
    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch mamba2-130m \
        --full --steps 300                                           # real 130M
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 20

The checkpoints go to ``--ckpt-dir`` (default: ``repro_torch_ckpt``
under the temporary directory); a run resumes from the latest one there.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.train import train_loop
from repro_torch.models.common import Family, ModelConfig


def default_cfg() -> ModelConfig:
    return ModelConfig(name="demo-15m", family=Family.DENSE, n_layers=6,
                       d_model=384, n_heads=6, n_kv_heads=2, d_ff=1024,
                       vocab=8192, tie_embeddings=True, remat=False)


def main(argv=None) -> list:
    """Trains; returns the losses."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.arch:
        cfg = get_config(args.arch) if args.full \
            else get_smoke_config(args.arch)
    else:
        cfg = default_cfg()
    _, _, losses = train_loop(cfg, steps=args.steps, batch=args.batch,
                              seq=args.seq, seed=0, ckpt_dir=args.ckpt_dir,
                              ckpt_every=50, lr=args.lr, device=args.device)
    print(f"final: first5={np.mean(losses[:5]):.4f} "
          f"last5={np.mean(losses[-5:]):.4f}")
    return losses


if __name__ == "__main__":
    main()

"""Family dispatch: one uniform API over the architecture families.

Counterpart of ``repro/models/registry.py``::

    init_params(cfg, seed, device)                 -> model (nn.Module)
    train_forward(model, batch, cfg)               -> (logits, aux_loss)
    make_decode_state(cfg, batch, max_len, device) -> state
    prefill(model, batch, cfg, state)              -> (logits, state)
    decode_step(model, token, cfg, state)          -> (logits, state)

``batch`` is a dict with ``tokens [B,S]``.  Only the SSM family
(mamba2-130m) is ported; every other family raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import torch

from repro_torch.models import ssm_lm as _ssm
from repro_torch.models.common import Family, ModelConfig
from repro_torch.runtime import resolve_device

#: where each family that is not ported yet is queued
PENDING = {
    Family.DENSE: "ROADMAP A.4 (a dense model's serving slice, with "
                  "flash attention B2)",
    Family.MOE: "ROADMAP A.4 (MoE models, after the collectives)",
    Family.HYBRID: "ROADMAP A.4 (hybrid zamba2, after B2)",
    Family.ENCDEC: "ROADMAP A.4 (whisper enc-dec, after B2)",
    Family.VLM: "ROADMAP A.4 (paligemma VLM, after B2)",
}


def _ssm_only(cfg: ModelConfig) -> None:
    if cfg.family != Family.SSM:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family.value} family is not ported to "
            f"repro_torch yet; see {PENDING[cfg.family]}")


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """The model with random weights from ``seed``, on ``device``
    (``None``: the CUDA card).  Weights are drawn on the host, so a seed
    gives the same model on every device."""
    _ssm_only(cfg)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return _ssm.SSMLM(cfg).init_(gen).to(dev)


def train_forward(model, batch: dict, cfg: ModelConfig):
    """-> (logits [B,S,Vp], aux_loss); forward only in this port."""
    _ssm_only(cfg)
    return _ssm.ssm_lm_apply(model, batch["tokens"], cfg)


def make_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device=None):
    _ssm_only(cfg)
    return _ssm.ssm_make_state(cfg, batch, max_len,
                               device=resolve_device(device))


def prefill(model, batch: dict, cfg: ModelConfig, state):
    _ssm_only(cfg)
    return _ssm.ssm_prefill(model, batch["tokens"], cfg, state)


def decode_step(model, token, cfg: ModelConfig, state):
    _ssm_only(cfg)
    return _ssm.ssm_decode_step(model, token, cfg, state)

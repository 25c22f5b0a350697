"""Family dispatch: one uniform API over the architecture families.

Counterpart of ``repro/models/registry.py``::

    init_params(cfg, seed, device)                 -> model (nn.Module)
    train_forward(model, batch, cfg)               -> (logits, aux_loss)
    make_decode_state(cfg, batch, max_len, device) -> state
    prefill(model, batch, cfg, state)              -> (logits, state)
    decode_step(model, token, cfg, state)          -> (logits, state)

``batch`` is a dict with ``tokens [B,S]``.  The SSM family (mamba2-130m),
the dense family (qwen2, llama3, stablelm, codeqwen) and the MoE family
(granite-moe, qwen2-moe; the transformer with MoE layers) are ported;
every other family raises ``NotImplementedError`` naming the ROADMAP
item that ports it.
"""

from __future__ import annotations

import torch

from repro_torch.models import ssm_lm as _ssm
from repro_torch.models import transformer as _tf
from repro_torch.models.common import Family, ModelConfig
from repro_torch.runtime import resolve_device

#: where each family that is not ported yet is queued
PENDING = {
    Family.HYBRID: "ROADMAP A.4 (hybrid zamba2)",
    Family.ENCDEC: "ROADMAP A.4 (whisper enc-dec)",
    Family.VLM: "ROADMAP A.4 (paligemma VLM)",
}


def _module(cfg: ModelConfig):
    if cfg.family == Family.SSM:
        return _ssm
    if cfg.family in (Family.DENSE, Family.MOE):
        return _tf
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family.value} family is not ported to "
        f"repro_torch yet; see {PENDING[cfg.family]}")


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """The model with random weights from ``seed``, on ``device``
    (``None``: the CUDA card).  Weights are drawn on the host, so a seed
    gives the same model on every device."""
    mod = _module(cfg)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if mod is _tf:
        return _tf.DenseLM(cfg, device=dev).init_(gen)
    return _ssm.SSMLM(cfg).init_(gen).to(dev)


def train_forward(model, batch: dict, cfg: ModelConfig):
    """-> (logits [B,S,Vp], aux_loss); forward only in this port."""
    if _module(cfg) is _tf:
        return _tf.lm_apply(model, batch["tokens"], cfg)
    return _ssm.ssm_lm_apply(model, batch["tokens"], cfg)


def make_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device=None):
    dev = resolve_device(device)
    if _module(cfg) is _tf:
        return _tf.lm_make_state(cfg, batch, max_len, device=dev)
    return _ssm.ssm_make_state(cfg, batch, max_len, device=dev)


def prefill(model, batch: dict, cfg: ModelConfig, state):
    if _module(cfg) is _tf:
        return _tf.lm_prefill(model, batch["tokens"], cfg, state)
    return _ssm.ssm_prefill(model, batch["tokens"], cfg, state)


def decode_step(model, token, cfg: ModelConfig, state):
    if _module(cfg) is _tf:
        return _tf.lm_decode_step(model, token, cfg, state)
    return _ssm.ssm_decode_step(model, token, cfg, state)

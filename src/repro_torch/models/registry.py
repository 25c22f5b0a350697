"""Family dispatch: one uniform API over the architecture families.

Counterpart of ``repro/models/registry.py``::

    init_params(cfg, seed, device)                 -> model (nn.Module)
    train_forward(model, batch, cfg)               -> (logits, aux_loss)
    make_decode_state(cfg, batch, max_len, device) -> state
    prefill(model, batch, cfg, state)              -> (logits, state)
    decode_step(model, token, cfg, state)          -> (logits, state)

``batch`` is a dict with ``tokens [B,S]``, and ``frames [B,F,D]`` (the
enc-dec family's stub conv output) for whisper.  The SSM family
(mamba2-130m), the dense family (qwen2, llama3, stablelm, codeqwen),
the MoE family (granite-moe, qwen2-moe; the transformer with MoE
layers), the hybrid family (zamba2-7b) and the enc-dec family
(whisper-large-v3) are ported; the VLM family raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import torch

from repro_torch.models import encdec as _encdec
from repro_torch.models import hybrid as _hybrid
from repro_torch.models import ssm_lm as _ssm
from repro_torch.models import transformer as _tf
from repro_torch.models.common import Family, ModelConfig
from repro_torch.runtime import resolve_device

#: where each family that is not ported yet is queued
PENDING = {
    Family.VLM: "ROADMAP A.4 (paligemma VLM)",
}


def _module(cfg: ModelConfig):
    if cfg.family == Family.SSM:
        return _ssm
    if cfg.family in (Family.DENSE, Family.MOE):
        return _tf
    if cfg.family == Family.HYBRID:
        return _hybrid
    if cfg.family == Family.ENCDEC:
        return _encdec
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family.value} family is not ported to "
        f"repro_torch yet; see {PENDING[cfg.family]}")


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """The model with random weights from ``seed``, on ``device``
    (``None``: the CUDA card).  Weights are drawn on the host, so a seed
    gives the same model on every device; every family but the small
    SSM one allocates its parameters on the device and copies each
    tensor there as it is drawn."""
    mod = _module(cfg)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if mod is _tf:
        return _tf.DenseLM(cfg, device=dev).init_(gen)
    if mod is _hybrid:
        return _hybrid.HybridLM(cfg, device=dev).init_(gen)
    if mod is _encdec:
        return _encdec.EncDecLM(cfg, device=dev).init_(gen)
    return _ssm.SSMLM(cfg).init_(gen).to(dev)


def train_forward(model, batch: dict, cfg: ModelConfig):
    """-> (logits [B,S,Vp], aux_loss); forward only in this port."""
    mod, tokens = _module(cfg), batch["tokens"]
    if mod is _tf:
        return _tf.lm_apply(model, tokens, cfg)
    if mod is _hybrid:
        return _hybrid.hybrid_apply(model, tokens, cfg)
    if mod is _encdec:
        return _encdec.encdec_apply(model, batch["frames"], tokens, cfg)
    return _ssm.ssm_lm_apply(model, tokens, cfg)


def make_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device=None, enc=None):
    """``enc``: the enc-dec family's encoder states (default zeros; the
    prefill fills them)."""
    mod, dev = _module(cfg), resolve_device(device)
    if mod is _tf:
        return _tf.lm_make_state(cfg, batch, max_len, device=dev)
    if mod is _hybrid:
        return _hybrid.hybrid_make_state(cfg, batch, max_len, device=dev)
    if mod is _encdec:
        return _encdec.encdec_make_state(cfg, batch, max_len, enc=enc,
                                         device=dev)
    return _ssm.ssm_make_state(cfg, batch, max_len, device=dev)


def prefill(model, batch: dict, cfg: ModelConfig, state):
    """The enc-dec family first encodes ``batch["frames"]`` into the
    state, as the reference's registry does."""
    mod, tokens = _module(cfg), batch["tokens"]
    if mod is _tf:
        return _tf.lm_prefill(model, tokens, cfg, state)
    if mod is _hybrid:
        return _hybrid.hybrid_prefill(model, tokens, cfg, state)
    if mod is _encdec:
        enc = _encdec.encode(model, batch["frames"], cfg)
        return _encdec.encdec_prefill(model, tokens, cfg,
                                      state._replace(enc=enc))
    return _ssm.ssm_prefill(model, tokens, cfg, state)


def decode_step(model, token, cfg: ModelConfig, state):
    mod = _module(cfg)
    if mod is _tf:
        return _tf.lm_decode_step(model, token, cfg, state)
    if mod is _hybrid:
        return _hybrid.hybrid_decode_step(model, token, cfg, state)
    if mod is _encdec:
        return _encdec.encdec_decode_step(model, token, cfg, state)
    return _ssm.ssm_decode_step(model, token, cfg, state)

"""Family dispatch: one uniform API over the architecture families.

Counterpart of ``repro/models/registry.py``::

    init_params(cfg, seed, device)                 -> model (nn.Module)
    train_forward(model, batch, cfg)               -> (logits, aux_loss)
    trainable(cfg)                                 -> None, or ValueError
    make_decode_state(cfg, batch, max_len, device) -> state
    prefill(model, batch, cfg, state)              -> (logits, state)
    decode_step(model, token, cfg, state)          -> (logits, state)

``batch`` is a dict with ``tokens [B,S]``, and ``frames [B,F,D]`` (the
enc-dec family's stub conv output) for whisper or ``patches [B,P,D]``
(the VLM's stub vision-tower output) for paligemma.  Every family is
ported: SSM (mamba2-130m), dense (qwen2, llama3, stablelm, codeqwen),
MoE (granite-moe, qwen2-moe; the transformer with MoE layers), hybrid
(zamba2-7b), enc-dec (whisper-large-v3) and VLM (paligemma-3b; the
transformer over the patches and the tokens, with the prefix-LM
mask).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import MAX_BWD_HEAD_DIM
from repro_torch.models import encdec as _encdec
from repro_torch.models import hybrid as _hybrid
from repro_torch.models import ssm_lm as _ssm
from repro_torch.models import transformer as _tf
from repro_torch.models import vlm as _vlm
from repro_torch.models.common import Family, ModelConfig
from repro_torch.runtime import resolve_device


def _module(cfg: ModelConfig):
    if cfg.family == Family.SSM:
        return _ssm
    if cfg.family in (Family.DENSE, Family.MOE):
        return _tf
    if cfg.family == Family.HYBRID:
        return _hybrid
    if cfg.family == Family.ENCDEC:
        return _encdec
    if cfg.family == Family.VLM:
        return _vlm
    raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


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
    if mod is _vlm:
        return _vlm.init_vlm(cfg, gen, device=dev)
    return _ssm.SSMLM(cfg).init_(gen).to(dev)


def trainable(cfg: ModelConfig) -> None:
    """Raises ``ValueError`` unless every kernel of ``cfg``'s forward has
    a backward kernel: the dense family up to head dim
    ``MAX_BWD_HEAD_DIM`` (B2's backward builds; B4's backward takes
    every width), the SSM family (B3's and B4's backward) and the hybrid
    family (B2's, B3's and B4's).  The VLM's head dim 256 waits for B2's
    backward there, and the MoE and enc-dec families for their training
    on the card (ROADMAP A.5)."""
    if cfg.family not in (Family.DENSE, Family.SSM, Family.HYBRID):
        missing = {Family.VLM: f"B2's backward at head dim {cfg.hd}"}.get(
            cfg.family, f"the {cfg.family.value} family's training path")
        raise ValueError(f"{cfg.name}: the port trains the dense, SSM and "
                         f"hybrid families; the {cfg.family.value} family "
                         f"waits for {missing} (ROADMAP A.5)")
    if cfg.family != Family.SSM and cfg.hd > MAX_BWD_HEAD_DIM:
        raise ValueError(f"{cfg.name}: head dim {cfg.hd}; B2's backward is "
                         f"built up to {MAX_BWD_HEAD_DIM}, a larger head "
                         f"dim waits for ROADMAP A.5")


def train_forward(model, batch: dict, cfg: ModelConfig):
    """-> (logits [B,S,Vp] over the *token* part, aux_loss), under the
    caller's grad mode.  The dense, SSM and hybrid families are
    differentiable: their compute dicts are cast anew from the masters
    with gradients on every call.  A model of another family (or a
    larger head dim, :func:`trainable`) whose parameters require a
    gradient raises ``ValueError``; with frozen parameters every family
    runs its forward, without gradients."""
    mod, tokens = _module(cfg), batch["tokens"]
    if torch.is_grad_enabled() and any(p.requires_grad
                                       for p in model.parameters()):
        trainable(cfg)
    if mod is _tf and cfg.family == Family.DENSE:
        return _tf.lm_train_apply(model, tokens, cfg)
    if mod is _tf:
        return _tf.lm_apply(model, tokens, cfg)
    if mod is _vlm:
        logits, aux = _vlm.vlm_apply(model, batch["patches"], tokens, cfg)
        return logits[:, cfg.img_tokens:], aux   # the text positions
    if mod is _hybrid:
        return _hybrid.hybrid_train_apply(model, tokens, cfg)
    if mod is _encdec:
        return _encdec.encdec_apply(model, batch["frames"], tokens, cfg)
    return _ssm.ssm_lm_train_apply(model, tokens, cfg)


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
    if mod is _vlm:
        return _vlm.vlm_make_state(cfg, batch, max_len, device=dev)
    return _ssm.ssm_make_state(cfg, batch, max_len, device=dev)


def prefill(model, batch: dict, cfg: ModelConfig, state):
    """The enc-dec family first encodes ``batch["frames"]`` into the
    state, as the reference's registry does; the VLM reads
    ``batch["patches"]``."""
    mod, tokens = _module(cfg), batch["tokens"]
    if mod is _tf:
        return _tf.lm_prefill(model, tokens, cfg, state)
    if mod is _hybrid:
        return _hybrid.hybrid_prefill(model, tokens, cfg, state)
    if mod is _encdec:
        enc = _encdec.encode(model, batch["frames"], cfg)
        return _encdec.encdec_prefill(model, tokens, cfg,
                                      state._replace(enc=enc))
    if mod is _vlm:
        return _vlm.vlm_prefill(model, batch["patches"], tokens, cfg, state)
    return _ssm.ssm_prefill(model, tokens, cfg, state)


def decode_step(model, token, cfg: ModelConfig, state):
    mod = _module(cfg)
    if mod is _tf:
        return _tf.lm_decode_step(model, token, cfg, state)
    if mod is _hybrid:
        return _hybrid.hybrid_decode_step(model, token, cfg, state)
    if mod is _encdec:
        return _encdec.encdec_decode_step(model, token, cfg, state)
    if mod is _vlm:
        return _vlm.vlm_decode_step(model, token, cfg, state)
    return _ssm.ssm_decode_step(model, token, cfg, state)

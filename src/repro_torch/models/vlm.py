"""VLM backbone (paligemma-3b shape): a gemma-style decoder over [image
patch embeddings ; text tokens] with a prefix-LM mask.

Counterpart of ``repro/models/vlm.py``.  The SigLIP vision tower is a
stub, as in the reference: the model takes precomputed patch embeddings
``[B, img_tokens, D]`` (what the projector would emit).  Everything else
is the dense transformer (:mod:`repro_torch.models.transformer`): the
patches are cast to ``cfg.dtype`` and put before the token embeddings,
the positions run over both, and the prefill's attention runs on the
flash kernel B2 with the prefix-LM mask (the first ``img_tokens``
positions see each other).  Decode is the dense family's step.
:func:`vlm_train_apply` is the training forward: B2 at head dim 256 and
B4 return through their autograd Functions, whose backward kernels give
the gradient.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import (DenseLM, LMDecodeState,
                                            _forward, lm_apply,
                                            lm_decode_step, lm_make_state,
                                            lm_prefill)


def init_vlm(cfg: ModelConfig, gen: torch.Generator, device=None) -> DenseLM:
    """The reference's ``init_vlm`` (its ``init_lm``): the dense LM with
    random weights from ``gen``, on ``device``."""
    return DenseLM(cfg, device=device).init_(gen)


def vlm_apply(model: DenseLM, patches: torch.Tensor, tokens: torch.Tensor,
              cfg: ModelConfig):
    """patches ``[B, img_tokens, D]`` stub embeddings; tokens ``[B, S]``
    -> (logits ``[B, img_tokens + S, Vp]``, aux loss)."""
    return lm_apply(model, tokens, cfg, extra_embeds=patches,
                    prefix_len=cfg.img_tokens)


def vlm_train_apply(model: DenseLM, patches: torch.Tensor,
                    tokens: torch.Tensor, cfg: ModelConfig):
    """patches ``[B, img_tokens, D]``; tokens ``[B, S]`` -> (logits
    ``[B, S, Vp]`` at the text positions, aux loss), under the caller's
    grad mode: the compute dict is cast anew from the float32 masters
    (``lm_train_apply``'s rule), and the patches are inputs, not
    parameters (the reference takes no gradient of them either).  The
    reference computes the logits at every position and keeps the text
    ones (``repro/models/registry.py:47-48``); the head here reads the
    text positions only, the same function row by row, without the
    image positions' ``[B, img_tokens, Vp]`` logits and their
    gradient."""
    return _forward(model._cast(), tokens, cfg, extra_embeds=patches,
                    prefix_len=cfg.img_tokens, logits_from=cfg.img_tokens)


def vlm_prefill(model: DenseLM, patches: torch.Tensor, tokens: torch.Tensor,
                cfg: ModelConfig, state: LMDecodeState):
    return lm_prefill(model, tokens, cfg, state, extra_embeds=patches,
                      prefix_len=cfg.img_tokens)


vlm_make_state = lm_make_state
vlm_decode_step = lm_decode_step

__all__ = ["init_vlm", "vlm_apply", "vlm_decode_step", "vlm_make_state",
           "vlm_prefill", "vlm_train_apply"]

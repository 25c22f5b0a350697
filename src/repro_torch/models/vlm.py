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
"""

from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import (DenseLM, LMDecodeState,
                                            lm_apply, lm_decode_step,
                                            lm_make_state, lm_prefill)


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


def vlm_prefill(model: DenseLM, patches: torch.Tensor, tokens: torch.Tensor,
                cfg: ModelConfig, state: LMDecodeState):
    return lm_prefill(model, tokens, cfg, state, extra_embeds=patches,
                      prefix_len=cfg.img_tokens)


vlm_make_state = lm_make_state
vlm_decode_step = lm_decode_step

__all__ = ["init_vlm", "vlm_apply", "vlm_decode_step", "vlm_make_state",
           "vlm_prefill"]

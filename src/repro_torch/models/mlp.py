"""Dense feed-forward blocks: SwiGLU / GeGLU / plain two-layer MLP.

Counterpart of ``repro/models/mlp.py``.  A layer's compute weights
(:meth:`repro_torch.models.transformer.DenseLM.weights`) hold ``w_in``
and ``w_gate`` side by side as ``w_in_gate`` ``[D, 2F]`` when the block
is gated, so that one product computes both, and ``w_out``.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig, activation


def mlp(w: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.glu:
        h, g = torch.chunk(x @ w["w_in_gate"], 2, dim=-1)
        h = activation(g, cfg.act) * h
    else:
        h = activation(x @ w["w_in"], cfg.act)
    return h @ w["w_out"]

"""Dense feed-forward blocks: SwiGLU / GeGLU / plain two-layer MLP.

Counterpart of ``repro/models/mlp.py``.  :class:`MLP` holds a block's
float32 masters under the reference's names; :func:`mlp_weights` casts
them to the compute dict that :func:`mlp` reads: ``w_in`` and
``w_gate`` side by side as ``w_in_gate`` ``[D, 2F]`` when the block is
gated, so that one product computes both (the pair itself on DTensors,
:func:`~repro_torch.models.common.join`), and ``w_out``.  On DTensors
the output comes back to the batch-over-data layout, as the
attention's does.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import (ModelConfig, activation, constrain,
                                       dp_spec, join, split_product)


def param(shape, cfg: ModelConfig, device, fill: float = 0.0,
          dtype=None) -> nn.Parameter:
    """A frozen parameter of ``shape`` in ``dtype`` (default
    ``cfg.param_dtype``), filled with ``fill``."""
    return nn.Parameter(torch.full(shape, fill,
                                   dtype=dtype or cfg.param_dtype,
                                   device=device), requires_grad=False)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None,
                 d_ff: int | None = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.w_in = param((d, f), cfg, device)
        self.w_out = param((f, d), cfg, device)
        if cfg.glu:
            self.w_gate = param((d, f), cfg, device)


def mlp_weights(m: MLP, cfg: ModelConfig) -> dict:
    """The compute dict of block ``m`` in ``cfg.dtype``."""
    dt = cfg.dtype
    w = {"w_out": m.w_out.to(dt)}
    if cfg.glu:
        w["w_in_gate"] = join([m.w_in.to(dt), m.w_gate.to(dt)], dim=-1)
    else:
        w["w_in"] = m.w_in.to(dt)
    return w


def mlp(w: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.glu:
        f = w["w_out"].shape[0]
        h, g = split_product(x, w["w_in_gate"], (f, f))
        h = activation(g, cfg.act) * h
    else:
        h = activation(x @ w["w_in"], cfg.act)
    y = h @ w["w_out"]
    return constrain(y, dp_spec(y), None, None)

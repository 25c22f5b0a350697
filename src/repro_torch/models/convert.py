"""Carry the reference's model weights into the port.

Counterpart, on the model side, of :mod:`repro_torch.dragonfly.convert`.
The reference keeps an SSM LM's parameters as a pytree whose per-layer
leaves are stacked ``[L, ...]``; its plain values (``jax.tree_util.
tree_map(np.asarray, params)``) are a nested dict of NumPy arrays::

    {"embed": [Vp, D], "ln_f": [D],
     "blocks": {"ln": [L, D], "mamba": {"w_z": [L, D, E], ...}}}

:func:`ssm_lm_from_reference` unstacks the per-layer leaves into the
port's :class:`~repro_torch.models.ssm_lm.SSMLM` (keeping ``embed`` at
its ``vocab_padded`` rows and the masters in ``cfg.param_dtype``), so
both compute the same functions.  This module imports nothing of
``repro``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import Family, ModelConfig
from repro_torch.models.ssm_lm import SSMLM
from repro_torch.runtime import resolve_device


def ssm_state_dict(params: dict, cfg: ModelConfig) -> dict:
    """The port's state dict for the reference parameters ``params``."""
    if cfg.family != Family.SSM:
        raise NotImplementedError(f"{cfg.family.value}: only the SSM "
                                  "family is ported")

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            cfg.param_dtype)

    embed = np.asarray(params["embed"])
    if embed.shape != (cfg.vocab_padded, cfg.d_model):
        raise ValueError(f"embed {embed.shape}, config wants "
                         f"{(cfg.vocab_padded, cfg.d_model)}")
    out = {"embed": t(embed), "ln_f": t(params["ln_f"])}
    blocks = params["blocks"]
    n_layers = np.asarray(blocks["ln"]).shape[0]
    if n_layers != cfg.n_layers:
        raise ValueError(f"{n_layers} stacked layers, config has "
                         f"{cfg.n_layers}")
    for i in range(n_layers):
        out[f"blocks.{i}.ln"] = t(np.asarray(blocks["ln"])[i])
        for name, leaf in blocks["mamba"].items():
            out[f"blocks.{i}.mamba.{name}"] = t(np.asarray(leaf)[i])
    return out


def ssm_lm_from_reference(params: dict, cfg: ModelConfig,
                          device=None) -> SSMLM:
    """A port model on ``device`` (``None``: the CUDA card) holding the
    reference parameters ``params``."""
    dev = resolve_device(device)
    model = SSMLM(cfg)
    model.load_state_dict(ssm_state_dict(params, cfg), strict=True)
    return model.to(dev)

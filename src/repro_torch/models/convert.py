"""Carry the reference's model weights into the port.

Counterpart, on the model side, of :mod:`repro_torch.dragonfly.convert`.
The reference keeps an LM's parameters as a pytree whose per-layer
leaves are stacked ``[L, ...]``; its plain values (``jax.tree_util.
tree_map(np.asarray, params)``) are a nested dict of NumPy arrays::

    SSM:   {"embed": [Vp, D], "ln_f": [D],
            "blocks": {"ln": [L, D], "mamba": {"w_z": [L, D, E], ...}}}
    dense: {"embed": [Vp, D], "ln_f": [D], ("lm_head": [D, Vp]),
            "blocks": {"ln1": [L, D], "ln2": [L, D],
                       "attn": {"wq": [L, D, H hd], ...},
                       "mlp": {"w_in": [L, D, F], ...}}}
    MoE:   as dense, with "moe" in place of "mlp":
           {"router": [L, D, E], "w_in": [L, E, D, F], "w_gate": ...,
            "w_out": [L, E, F, D], ("shared": {"w_in": [L, D, Fs], ...})}

:func:`ssm_lm_from_reference` and :func:`dense_lm_from_reference`
unstack the per-layer leaves into the port's
:class:`~repro_torch.models.ssm_lm.SSMLM` and
:class:`~repro_torch.models.transformer.DenseLM` (keeping ``embed`` at
its ``vocab_padded`` rows, the MoE router in float32 and the other
masters in ``cfg.param_dtype``), so both compute the same functions.
This module imports nothing of ``repro``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import Family, ModelConfig
from repro_torch.models.ssm_lm import SSMLM
from repro_torch.models.transformer import DenseLM
from repro_torch.runtime import resolve_device


def _tensor(a, cfg: ModelConfig, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        dtype or cfg.param_dtype)


def _common(params: dict, cfg: ModelConfig, families: tuple,
            first_leaf: str) -> dict:
    """Checks the family, ``embed``'s shape and the layer count; returns
    the state dict's ``embed`` and ``ln_f``."""
    if cfg.family not in families:
        raise NotImplementedError(
            f"{cfg.family.value}: want the "
            f"{' or the '.join(f.value for f in families)} family")
    embed = np.asarray(params["embed"])
    if embed.shape != (cfg.vocab_padded, cfg.d_model):
        raise ValueError(f"embed {embed.shape}, config wants "
                         f"{(cfg.vocab_padded, cfg.d_model)}")
    n_layers = np.asarray(params["blocks"][first_leaf]).shape[0]
    if n_layers != cfg.n_layers:
        raise ValueError(f"{n_layers} stacked layers, config has "
                         f"{cfg.n_layers}")
    return {"embed": _tensor(embed, cfg), "ln_f": _tensor(params["ln_f"], cfg)}


def ssm_state_dict(params: dict, cfg: ModelConfig) -> dict:
    """The port's SSM state dict for the reference parameters
    ``params``."""
    out = _common(params, cfg, (Family.SSM,), "ln")
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        out[f"blocks.{i}.ln"] = _tensor(np.asarray(blocks["ln"])[i], cfg)
        for name, leaf in blocks["mamba"].items():
            out[f"blocks.{i}.mamba.{name}"] = _tensor(np.asarray(leaf)[i],
                                                      cfg)
    return out


def ssm_lm_from_reference(params: dict, cfg: ModelConfig,
                          device=None) -> SSMLM:
    """A port model on ``device`` (``None``: the CUDA card) holding the
    reference parameters ``params``."""
    dev = resolve_device(device)
    model = SSMLM(cfg)
    model.load_state_dict(ssm_state_dict(params, cfg), strict=True)
    return model.to(dev)


def _layer_leaves(out: dict, prefix: str, tree: dict, i: int,
                  cfg: ModelConfig) -> None:
    """Layer ``i`` of every stacked leaf of ``tree``, under ``prefix``;
    the MoE router stays float32, as the reference keeps it."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _layer_leaves(out, f"{prefix}{name}.", leaf, i, cfg)
        else:
            out[prefix + name] = _tensor(
                np.asarray(leaf)[i], cfg,
                torch.float32 if prefix.endswith(".moe.") and
                name == "router" else None)


def dense_state_dict(params: dict, cfg: ModelConfig) -> dict:
    """The port's state dict of the transformer (dense or MoE family) for
    the reference parameters ``params``; ``lm_head`` is taken when the
    config is untied."""
    out = _common(params, cfg, (Family.DENSE, Family.MOE), "ln1")
    if not cfg.tie_embeddings:
        out["lm_head"] = _tensor(params["lm_head"], cfg)
    for i in range(cfg.n_layers):
        _layer_leaves(out, f"blocks.{i}.", params["blocks"], i, cfg)
    return out


def dense_lm_from_reference(params: dict, cfg: ModelConfig,
                            device=None) -> DenseLM:
    """A port model on ``device`` (``None``: the CUDA card) holding the
    reference parameters ``params``; shapes are checked by the strict
    load."""
    model = DenseLM(cfg, device=resolve_device(device))
    model.load_state_dict(dense_state_dict(params, cfg), strict=True)
    return model

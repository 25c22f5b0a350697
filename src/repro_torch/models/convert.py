"""Carry the reference's model weights into the port.

Counterpart, on the model side, of :mod:`repro_torch.dragonfly.convert`.
The reference keeps an LM's parameters as a pytree whose per-layer
leaves are stacked ``[L, ...]``; its plain values (``jax.tree_util.
tree_map(np.asarray, params)``) are a nested dict of NumPy arrays::

    SSM:   {"embed": [Vp, D], "ln_f": [D],
            "blocks": {"ln": [L, D], "mamba": {"w_z": [L, D, E], ...}}}
    dense (and VLM, whose ``init_vlm`` is ``init_lm``):
           {"embed": [Vp, D], "ln_f": [D], ("lm_head": [D, Vp]),
            "blocks": {"ln1": [L, D], "ln2": [L, D],
                       "attn": {"wq": [L, D, H hd], ...},
                       "mlp": {"w_in": [L, D, F], ...}}}
    MoE:   as dense, with "moe" in place of "mlp":
           {"router": [L, D, E], "w_in": [L, E, D, F], "w_gate": ...,
            "w_out": [L, E, F, D], ("shared": {"w_in": [L, D, Fs], ...})}
    hybrid: {"embed", "ln_f", "lm_head",
             "main": {"ln": [n_super, period, D], "mamba": {...}},
             "shared": {"ln1": [D], "attn": {"wq": [D, H hd], ...},
                        "ln2": [D], "mlp": {...}},
             ("trailing": {"ln": [rem, D], "mamba": {...}})}
    enc-dec: {"embed", "pos_enc": [F, D], "enc_ln", "ln_f", "lm_head",
              "enc_blocks": {"ln1", "attn", "ln2", "mlp"} stacked [Le, ...],
              "dec_blocks": {"ln1", "self_attn", "ln_x", "cross_attn",
                             "ln2", "mlp"} stacked [L, ...]}

:func:`ssm_lm_from_reference`, :func:`dense_lm_from_reference`,
:func:`hybrid_from_reference` and :func:`encdec_from_reference` unstack
the per-layer leaves into the port's
:class:`~repro_torch.models.ssm_lm.SSMLM`,
:class:`~repro_torch.models.transformer.DenseLM`,
:class:`~repro_torch.models.hybrid.HybridLM` and
:class:`~repro_torch.models.encdec.EncDecLM` (keeping ``embed`` at its
``vocab_padded`` rows, the MoE router in float32 and the other masters
in ``cfg.param_dtype``), so both compute the same functions.  This
module imports nothing of ``repro``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import Family, ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM, hybrid_layout
from repro_torch.models.ssm_lm import SSMLM
from repro_torch.models.transformer import DenseLM
from repro_torch.runtime import resolve_device


def _tensor(a, cfg: ModelConfig, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        dtype or cfg.param_dtype)


def _stacked(leaf, want: tuple, what: str) -> None:
    """Checks the leading (stacked) dims of ``leaf``."""
    got = np.asarray(leaf).shape[:len(want)]
    if got != want:
        raise ValueError(f"{what}: {got} stacked layers, config has "
                         f"{want}")


def _common(params: dict, cfg: ModelConfig, families: tuple,
            first_leaf: str | None = None) -> dict:
    """Checks the family, ``embed``'s shape and, given ``first_leaf``, the
    layer count of ``blocks``; returns the state dict's ``embed`` and
    ``ln_f``."""
    if cfg.family not in families:
        raise NotImplementedError(
            f"{cfg.family.value}: want the "
            f"{' or the '.join(f.value for f in families)} family")
    embed = np.asarray(params["embed"])
    if embed.shape != (cfg.vocab_padded, cfg.d_model):
        raise ValueError(f"embed {embed.shape}, config wants "
                         f"{(cfg.vocab_padded, cfg.d_model)}")
    if first_leaf is not None:
        _stacked(params["blocks"][first_leaf], (cfg.n_layers,), "blocks")
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
    """The port's state dict of the transformer (dense, MoE or VLM
    family) for the reference parameters ``params``; ``lm_head`` is taken
    when the config is untied (paligemma's is tied: the head is
    ``embed``)."""
    out = _common(params, cfg, (Family.DENSE, Family.MOE, Family.VLM),
                  "ln1")
    if not cfg.tie_embeddings:
        out["lm_head"] = _tensor(params["lm_head"], cfg)
    for i in range(cfg.n_layers):
        _layer_leaves(out, f"blocks.{i}.", params["blocks"], i, cfg)
    return out


def dense_lm_from_reference(params: dict, cfg: ModelConfig,
                            device=None) -> DenseLM:
    """A port model on ``device`` (``None``: the CUDA card) holding the
    reference parameters ``params`` of the dense, MoE or VLM family (the
    VLM is the dense LM, so this serves it: no ``vlm_from_reference``);
    shapes are checked by the strict load."""
    model = DenseLM(cfg, device=resolve_device(device))
    model.load_state_dict(dense_state_dict(params, cfg), strict=True)
    return model


def hybrid_state_dict(params: dict, cfg: ModelConfig) -> dict:
    """The port's hybrid state dict for the reference parameters
    ``params``: ``main`` unstacked over ``[n_super, period]``,
    ``trailing`` over ``[rem]``, ``shared`` as it is."""
    out = _common(params, cfg, (Family.HYBRID,))
    n_super, period, rem, _ = hybrid_layout(cfg)
    _stacked(params["main"]["ln"], (n_super, period), "main")
    out["lm_head"] = _tensor(params["lm_head"], cfg)
    for a in range(n_super):
        for j in range(period):
            _layer_leaves(out, f"main.{a}.{j}.", params["main"], (a, j), cfg)
    _layer_leaves(out, "shared.", params["shared"], (), cfg)
    if rem:
        _stacked(params["trailing"]["ln"], (rem,), "trailing")
        for r in range(rem):
            _layer_leaves(out, f"trailing.{r}.", params["trailing"], r, cfg)
    return out


def hybrid_from_reference(params: dict, cfg: ModelConfig,
                          device=None) -> HybridLM:
    """A port model on ``device`` (``None``: the CUDA card) holding the
    reference hybrid parameters ``params``."""
    model = HybridLM(cfg, device=resolve_device(device))
    model.load_state_dict(hybrid_state_dict(params, cfg), strict=True)
    return model


def encdec_state_dict(params: dict, cfg: ModelConfig) -> dict:
    """The port's enc-dec state dict for the reference parameters
    ``params``."""
    out = _common(params, cfg, (Family.ENCDEC,))
    _stacked(params["enc_blocks"]["ln1"], (cfg.n_encoder_layers,),
             "enc_blocks")
    _stacked(params["dec_blocks"]["ln1"], (cfg.n_layers,), "dec_blocks")
    for name in ("pos_enc", "enc_ln", "lm_head"):
        out[name] = _tensor(params[name], cfg)
    for i in range(cfg.n_encoder_layers):
        _layer_leaves(out, f"enc_blocks.{i}.", params["enc_blocks"], i, cfg)
    for i in range(cfg.n_layers):
        _layer_leaves(out, f"dec_blocks.{i}.", params["dec_blocks"], i, cfg)
    return out


def encdec_from_reference(params: dict, cfg: ModelConfig,
                          device=None) -> EncDecLM:
    """A port model on ``device`` (``None``: the CUDA card) holding the
    reference enc-dec parameters ``params``."""
    model = EncDecLM(cfg, device=resolve_device(device))
    model.load_state_dict(encdec_state_dict(params, cfg), strict=True)
    return model

"""Shared model configuration and primitive layers.

Counterpart of ``repro/models/common.py``.  One :class:`ModelConfig`
covers every architecture family, with the reference's fields; ``dtype``
(activations) and ``param_dtype`` (master weights) are torch dtypes.
The reference's mesh and sharding helpers and its remat wrapper are
left out: serving and training on one card use neither (the port keeps
every activation of a train step; remat changes no number).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, replace
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rmsnorm import rmsnorm_fused


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    ENCDEC = "encdec"
    VLM = "vlm"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int            # 0 for attention-free (ssm)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0       # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    act: str = "silu"           # silu => SwiGLU; gelu => GeGLU/plain
    glu: bool = True
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0        # per-expert hidden size
    router_aux_coef: float = 0.01
    moe_impl: str = "einsum"
    moe_a2a_mode: str = "direct"
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_expand: int = 2
    # --- hybrid (zamba2-like shared attention blocks) ---
    shared_attn_period: int = 6
    # --- enc-dec (whisper backbone; conv frontend is a stub) ---
    n_encoder_layers: int = 0
    encoder_frames: int = 1500
    # --- vlm (paligemma backbone; SigLIP frontend is a stub) ---
    img_tokens: int = 0
    # --- compute ---
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    remat_policy: str = "full"
    #: embeddings/heads are padded to a multiple of this
    pad_vocab_multiple: int = 128
    supports_long_context: bool = False

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def vocab_padded(self) -> int:
        m = max(self.pad_vocab_multiple, 1)
        return -(-self.vocab // m) * m

    @property
    def is_attention_free(self) -> bool:
        return self.family == Family.SSM

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return replace(self, **kw)


def normal(gen: torch.Generator, shape, scale: float,
           dtype) -> torch.Tensor:
    """``N(0, scale**2)`` draws from ``gen`` (a CPU generator, so the
    same seed gives the same weights on every device)."""
    return torch.randn(shape, generator=gen).mul_(scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(gen, (d_in, d_out), scale, dtype)


class CastCache(nn.Module):
    """A module whose compute copies of its parameters are made once,
    and dropped when the module moves (``.to``) or is reloaded, or by an
    optimizer step (``repro_torch.train.train_step.train_step`` sets
    ``_cw`` to ``None``: an in-place update does not pass ``_apply``).
    :meth:`weights` serves the cache, made under ``no_grad``; training
    calls :meth:`_cast` itself, so its copies carry the gradient."""

    def __init__(self):
        super().__init__()
        self._cw: dict | None = None

    def _apply(self, fn, *args, **kwargs):
        self._cw = None
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._cw = None
        return super()._load_from_state_dict(*args, **kwargs)

    def weights(self) -> dict:
        if self._cw is None:
            with torch.no_grad():
                self._cw = self._cast()
        return self._cw

    def _cast(self) -> dict:
        raise NotImplementedError


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm through the fused kernel (B4): ``x`` normalised in float32
    and multiplied by ``gamma`` in float32, then cast once to ``x``'s
    dtype.  The reference model's norm casts before it multiplies by a
    ``gamma`` already in ``x``'s dtype; the two differ by at most one
    rounding of that dtype, and not at all in float32 or where
    ``gamma`` is 1."""
    return rmsnorm_fused(x, gamma, eps)


# -------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half RoPE in float32, cast back to ``x``'s dtype.  x
    ``[..., S, H, hd]``; positions ``[..., S]`` int.  The frequencies
    are made on ``x``'s device: a copy from the host would synchronise
    the stream at every call."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    ang = positions[..., :, None].float() * freqs            # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The reference's activations; its ``gelu`` is jax's default, the
    tanh approximation."""
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {kind!r}")

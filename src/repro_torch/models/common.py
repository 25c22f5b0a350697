"""Shared model configuration and primitive layers.

Counterpart of ``repro/models/common.py``.  One :class:`ModelConfig`
covers every architecture family, with the reference's fields; ``dtype``
(activations) and ``param_dtype`` (master weights) are torch dtypes.
:func:`checkpoint_wrap` is the reference's activation recomputation: a
train step keeps each wrapped layer's inputs and recomputes the rest in
the backward (``torch.utils.checkpoint``), as ``cfg.remat`` and
``cfg.remat_policy`` say; it changes no number, only what a step keeps
and how much it computes, and a forward without gradients (every serve)
never enters it.  Its activation
sharding helpers (:func:`mesh_axes`, :func:`dp_spec`, :func:`constrain`)
read the mesh of the DTensor they are given, where the reference reads
the active mesh: the multi-pod dry run (:mod:`repro_torch.launch.dryrun`)
runs the models on DTensors, and on the plain tensors of the card's
serving and training paths each is a no-op after one ``isinstance``
check.  :func:`scoped` marks the regions the dry run's cost tracer
attributes to a named scope, as the reference's ``jax.named_scope``.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, replace
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

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
    #: "full" recomputes everything; "dots" saves the 2-D matrix
    #: products (the projections) and recomputes the rest
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


#: the products the "dots" policy saves: the 2-D matrix products (the
#: projections, the router, the head), which is what the reference's
#: ``dots_with_no_batch_dims_saveable`` keeps; batched products (``bmm``:
#: the MoE einsums, the plain attention and SSD), the kernels B2, B3 and
#: B4 and every elementwise op are recomputed
SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _saving_products():
    return create_selective_checkpoint_contexts(list(SAVED_PRODUCTS))


def checkpoint_wrap(fn, cfg: ModelConfig):
    """``fn`` under activation recomputation, as the reference's
    ``checkpoint_wrap`` (``jax.checkpoint``): ``fn`` itself where
    ``cfg.remat`` is off or grad mode is off (a serve); else ``fn`` run
    through ``torch.utils.checkpoint`` (non-reentrant), which keeps its
    inputs and drops what it saves for the backward, recomputing it
    there.  ``remat_policy == "dots"`` keeps the outputs of
    :data:`SAVED_PRODUCTS` from the first forward; any other policy
    recomputes everything ("full").  The models draw no random numbers,
    so no RNG state is stashed; the kernels' autograd Functions save
    through ``ctx.save_for_backward``, which the recomputation
    covers."""
    if not cfg.remat or not torch.is_grad_enabled():
        return fn
    extra = ({"context_fn": _saving_products}
             if cfg.remat_policy == "dots" else {})

    def run(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **extra, **kwargs)

    return run


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


# ----------------------------------------------------- activation sharding
def mesh_axes(x) -> dict:
    """Dim sizes of ``x``'s mesh, ``{}`` for a plain tensor."""
    if not isinstance(x, DTensor):
        return {}
    mesh = x.device_mesh
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_spec(x):
    """The data-parallel entry of a spec on ``x``'s mesh: ``("pod",
    "data")``, ``"data"`` or None."""
    axes = mesh_axes(x)
    if "pod" in axes and "data" in axes:
        return ("pod", "data")
    if "data" in axes:
        return "data"
    return None


def constrain(x, *spec):
    """``x`` redistributed to ``spec`` (one entry per leading dim: None,
    a mesh dim name or a tuple of names), divisibility-checked; a no-op
    on a plain tensor.  An entry whose dims are missing from the mesh,
    or whose tensor dim does not divide evenly, is dropped to None, as
    the reference's ``constrain`` drops it; pending sums (``Partial``)
    are reduced on the way.  As a sharding constraint binds the
    cotangent too in the reference, ``x``'s gradient is brought to the
    same placements."""
    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.local import pin
    from repro_torch.sharding.partition import placements
    axes = mesh_axes(x)
    cleaned = []
    for dim, ax in zip(x.shape, spec):
        group = ax if isinstance(ax, tuple) else (ax,)
        if ax is None or not all(a in axes for a in group):
            cleaned.append(None)
            continue
        size = math.prod(axes[a] for a in group)
        cleaned.append(ax if dim % size == 0 and dim >= size else None)
    cleaned += [None] * (x.ndim - len(cleaned))
    want = placements(cleaned, x.device_mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return pin(x) if x.requires_grad else x


def embed_rows(table, tokens):
    """``table[tokens]``: the embedding rows of ``tokens``; on DTensors
    (a vocab-sharded table) in the batch-over-data layout that the
    residual stream keeps."""
    x = table[tokens.long()]
    return constrain(x, dp_spec(x), None, None)


def is_sharded(t) -> bool:
    """Whether ``t`` is a DTensor (the dry run's)."""
    return isinstance(t, DTensor)


def join(ws: list, dim: int = -1):
    """The weights ``ws`` side by side along ``dim``, so that one
    product computes them all; for DTensors (the dry run's sharded
    weights, each sharded on its own) the tuple ``ws``, whose products
    :func:`split_product` keeps apart, as the reference computes
    them."""
    if isinstance(ws[0], DTensor):
        return tuple(ws)
    return torch.cat(ws, dim=dim)


def split_product(x, w, sizes, bias=None, product=torch.matmul):
    """``product(x, w) + bias`` split along the last dim into parts of
    ``sizes``, for ``w`` and ``bias`` made by :func:`join`; a tuple
    ``w`` gives each part its own product."""
    if isinstance(w, tuple):
        parts = [product(x, wi) for wi in w]
        if bias is not None:
            parts = [p + b for p, b in zip(parts, bias)]
        return tuple(parts)
    y = product(x, w)
    if bias is not None:
        y = y + bias
    return torch.split(y, list(sizes), dim=-1)


#: tracers of named regions (the dry run's cost tracer adds itself);
#: empty on every other path
SCOPE_TRACERS: list = []


def scoped(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, attributed to scope ``name`` by the
    innermost of :data:`SCOPE_TRACERS` (the reference's
    ``jax.named_scope``); with no tracer, just the call."""
    if not SCOPE_TRACERS:
        return fn(*args, **kwargs)
    tracer = SCOPE_TRACERS[-1]
    return tracer.run_scoped(name, fn, args, kwargs)

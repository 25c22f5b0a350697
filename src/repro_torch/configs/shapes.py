"""The assigned input-shape sets (one set, shared by all LM archs).

Counterpart of ``repro/configs/shapes.py``:

    train_4k      seq 4096,   global_batch 256   -> train_step
    prefill_32k   seq 32768,  global_batch 32    -> serve prefill
    decode_32k    seq 32768,  global_batch 128   -> serve decode (1 token
                                                    against a 32k cache)
    long_500k     seq 524288, global_batch 1     -> long-context decode;
                  needs sub-quadratic attention: SSM/hybrid only

:func:`input_specs` returns meta tensors (shape and dtype, nothing
allocated) where the reference returns ``jax.ShapeDtypeStruct``\\ s.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.common import Family, ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


class ShapeNotSupported(Exception):
    """Raised for documented skips (long_500k on pure full-attention)."""


def check_supported(cfg: ModelConfig, shape: InputShape) -> None:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        raise ShapeNotSupported(
            f"{cfg.name}: long_500k requires sub-quadratic attention "
            f"(documented skip for pure full-attention archs, DESIGN.md §4)")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Meta-tensor stand-ins for every model input (no allocation).

    train:   {tokens [B,S], labels [B,S]} (+ stub frontend inputs)
    prefill: {tokens [B,S]} (+ stubs)
    decode:  {tokens [B,1]}  (cache/state shapes come from make_decode_state)
    """
    check_supported(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    i32, f = torch.int32, torch.bfloat16
    if shape.kind == "train":
        specs = {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
    elif shape.kind == "prefill":
        specs = {"tokens": _meta((B, S), i32)}
    else:
        specs = {"tokens": _meta((B, 1), i32)}
    if cfg.family == Family.ENCDEC and shape.kind != "decode":
        specs["frames"] = _meta((B, cfg.encoder_frames, cfg.d_model), f)
    if cfg.family == Family.VLM and shape.kind != "decode":
        specs["patches"] = _meta((B, cfg.img_tokens, cfg.d_model), f)
    return specs

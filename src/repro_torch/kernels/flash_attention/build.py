"""The flash-attention CUDA library: the forward
(``csrc/flash_attention.cu``) and its backward
(``csrc/flash_attention_bwd.cu``), built with ``nvcc`` for ``sm_90a`` at
first use and loaded with ``ctypes`` (:mod:`repro_torch.kernels._build`)."""

from __future__ import annotations

from pathlib import Path

from repro_torch.kernels._build import HOPPER_HEADER, KernelLibrary

_CSRC = Path(__file__).resolve().parent / "csrc"

LIB = KernelLibrary(
    (_CSRC / "flash_attention.cu", _CSRC / "flash_attention_bwd.cu"),
    "flash_attention",
    {"flash_attention": ("ptr", "ptr", "ptr", "ptr", "i32", "i32", "i32",
                         "i32", "i32", "i32", "i32", "i32", "i32", "f32",
                         "ptr"),
     "flash_attention_bwd": ("ptr", "ptr", "ptr", "ptr", "ptr", "ptr", "ptr",
                             "ptr", "ptr", "ptr", "i32", "i32", "i32", "i32",
                             "i32", "i32", "i32", "i32", "i32", "f32",
                             "ptr")},
    headers=(HOPPER_HEADER,))

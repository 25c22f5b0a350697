"""The flash-attention CUDA library (``csrc/flash_attention.cu``), built
with ``nvcc`` for ``sm_90a`` at first use and loaded with ``ctypes``
(:mod:`repro_torch.kernels._build`)."""

from __future__ import annotations

from pathlib import Path

from repro_torch.kernels._build import HOPPER_HEADER, KernelLibrary

LIB = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    "flash_attention",
    {"flash_attention": ("ptr", "ptr", "ptr", "ptr", "i32", "i32", "i32",
                         "i32", "i32", "i32", "i32", "i32", "i32", "f32",
                         "ptr")},
    headers=(HOPPER_HEADER,))

"""The RMSNorm CUDA library: the forward (``csrc/rmsnorm.cu``) and its
backward (``csrc/rmsnorm_bwd.cu``), built with ``nvcc`` for ``sm_90a``
at first use and loaded with ``ctypes``
(:mod:`repro_torch.kernels._build`)."""

from __future__ import annotations

from pathlib import Path

from repro_torch.kernels._build import KernelLibrary

_CSRC = Path(__file__).resolve().parent / "csrc"

LIB = KernelLibrary(
    (_CSRC / "rmsnorm.cu", _CSRC / "rmsnorm_bwd.cu"), "rmsnorm",
    {"rmsnorm": ("ptr", "ptr", "ptr", "i64", "i32", "f32", "i32", "i32",
                 "ptr"),
     "rmsnorm_route": ("ptr", "ptr", "ptr", "i64", "i32", "i32"),
     "rmsnorm_bwd": ("ptr", "ptr", "ptr", "ptr", "ptr", "ptr", "i64", "i32",
                     "f32", "i32", "i32", "i32", "ptr")})

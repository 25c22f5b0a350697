"""The RMSNorm CUDA library (``csrc/rmsnorm.cu``), built with ``nvcc``
for ``sm_90a`` at first use and loaded with ``ctypes``
(:mod:`repro_torch.kernels._build`)."""

from __future__ import annotations

from pathlib import Path

from repro_torch.kernels._build import KernelLibrary

LIB = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu", "rmsnorm",
    {"rmsnorm": ("ptr", "ptr", "ptr", "i64", "i32", "f32", "i32", "i32",
                 "ptr"),
     "rmsnorm_route": ("ptr", "ptr", "ptr", "i64", "i32", "i32")})

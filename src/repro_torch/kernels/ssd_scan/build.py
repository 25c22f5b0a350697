"""The SSD within-chunk CUDA library (``csrc/ssd_scan.cu``), built with
``nvcc`` for ``sm_90a`` at first use and loaded with ``ctypes``
(:mod:`repro_torch.kernels._build`)."""

from __future__ import annotations

from pathlib import Path

from repro_torch.kernels._build import HOPPER_HEADER, KernelLibrary

LIB = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu", "ssd_scan",
    {"ssd_inner": ("ptr", "ptr", "ptr", "ptr", "ptr", "ptr", "ptr", "i32",
                   "i32", "i32", "i32", "i32", "i32", "i32", "ptr")},
    headers=(HOPPER_HEADER,))

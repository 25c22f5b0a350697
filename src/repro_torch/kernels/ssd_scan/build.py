"""The SSD within-chunk CUDA library: the forward (``csrc/ssd_scan.cu``)
and its backward (``csrc/ssd_scan_bwd.cu``), built with ``nvcc`` for
``sm_90a`` at first use and loaded with ``ctypes``
(:mod:`repro_torch.kernels._build`)."""

from __future__ import annotations

from pathlib import Path

from repro_torch.kernels._build import HOPPER_HEADER, KernelLibrary

_CSRC = Path(__file__).resolve().parent / "csrc"

LIB = KernelLibrary(
    (_CSRC / "ssd_scan.cu", _CSRC / "ssd_scan_bwd.cu"), "ssd_scan",
    {"ssd_inner": ("ptr", "ptr", "ptr", "ptr", "ptr", "ptr", "ptr", "i32",
                   "i32", "i32", "i32", "i32", "i32", "i32", "ptr"),
     "ssd_inner_bwd": ("ptr",) * 13 + ("i32",) * 8 + ("ptr",)},
    headers=(HOPPER_HEADER,))

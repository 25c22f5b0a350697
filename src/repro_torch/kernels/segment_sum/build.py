"""Build and load the segment-sum CUDA library at first use.

``nvcc`` compiles ``csrc/segment_sum.cu`` for ``sm_90a`` into a shared
library with a plain C interface under ``build/`` (listed in
``.gitignore``), and ``ctypes`` loads it (:mod:`repro_torch.kernels._build`).
Nothing happens at import: the CPU tests import this module on machines
without ``nvcc``.  A build failure raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels._build import BuildInfo, KernelLibrary

__all__ = ["BuildInfo", "LIB", "build", "load_library"]

LIB = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "segment_sum.cu",
    "segment_sum",
    {"segment_sum_sorted": ("ptr", "ptr", "i32", "ptr", "ptr"),
     "segment_sum_scatter": ("ptr", "ptr", "i64", "i32", "ptr", "ptr")})


def build() -> BuildInfo:
    """Compile the library unless one newer than the source exists."""
    return LIB.build()


def load_library() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    return LIB.load()

"""Build and load the segment-sum CUDA library at first use.

``nvcc`` compiles ``csrc/segment_sum.cu`` for ``sm_90a`` into a shared
library with a plain C interface under ``build/`` (listed in
``.gitignore``), and ``ctypes`` loads it.  Nothing happens at import:
the CPU tests import this module on machines without ``nvcc``.  A build
failure raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "csrc" / "segment_sum.cu"
BUILD_DIR = HERE / "build"
LIBRARY = BUILD_DIR / "libsegment_sum.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float      # 0.0 when an up-to-date library was reused
    log: str            # nvcc's output (ptxas register/spill report)


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or the default
    toolkit location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the segment-sum kernel is built "
                       "from source at first use and needs the CUDA toolkit")


@functools.cache
def build() -> BuildInfo:
    """Compile the library unless one newer than the source exists."""
    if LIBRARY.is_file() and \
            LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return BuildInfo(LIBRARY, 0.0, "")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = LIBRARY.with_suffix(f".so.{os.getpid()}")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, LIBRARY)        # atomic: concurrent builds race safely
    return BuildInfo(LIBRARY, seconds, log)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    lib = ctypes.CDLL(str(build().path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.segment_sum_sorted.argtypes = [ptr, ptr, i32, ptr, ptr]
    lib.segment_sum_sorted.restype = i32
    lib.segment_sum_scatter.argtypes = [ptr, ptr, i64, i32, ptr, ptr]
    lib.segment_sum_scatter.restype = i32
    return lib

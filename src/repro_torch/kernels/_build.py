"""Build and load a kernel's CUDA library at first use.

Each kernel subpackage keeps its source under ``csrc/`` and describes it
with one :class:`KernelLibrary`: the source, the library's name and the
C signatures of its entry points.  ``nvcc`` compiles the source for
``sm_90a`` into a shared library with a plain C interface under the
kernel's own ``build/`` (listed in ``.gitignore``), and ``ctypes`` loads
it.  Nothing happens at import: the CPU tests import every kernel module
on machines without ``nvcc``.  A build failure raises; there is no
fallback.  Every build goes through :func:`build_all`, which starts one
``nvcc`` per source together and waits for all of them.  Helpers shared
by several kernels (``wgmma``, TMA, ``mbarrier``) live in
:data:`HOPPER_HEADER`; a library is rebuilt when its source or any
header it names is newer than it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the Hopper helpers included by the tensor-core kernels
HOPPER_HEADER = Path(__file__).resolve().parent / "csrc" / "hopper.cuh"

#: ctypes argument codes used in signatures: pointers (and the stream)
#: must be ``c_void_p``, or ctypes passes them as 32-bit ints
CTYPES = {"ptr": ctypes.c_void_p, "i32": ctypes.c_int,
          "i64": ctypes.c_longlong, "f32": ctypes.c_float}


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
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "source at first use and need the CUDA toolkit")


class KernelLibrary:
    """One CUDA source built into ``build/lib<name>.so`` beside it.

    ``signatures`` maps each C entry point to its argument codes (keys
    of :data:`CTYPES`); every entry point returns an ``int`` error code.
    ``headers`` are the files the source includes from elsewhere in the
    package: an edit of one rebuilds the library.
    """

    def __init__(self, source: Path, name: str,
                 signatures: dict[str, tuple[str, ...]],
                 headers: tuple = ()):
        self.source = Path(source)
        self.headers = tuple(Path(h) for h in headers)
        self.build_dir = self.source.parent.parent / "build"
        self.path = self.build_dir / f"lib{name}.so"
        self.signatures = signatures
        self._info: BuildInfo | None = None
        self._lib: ctypes.CDLL | None = None

    def build(self) -> BuildInfo:
        """Compile the library unless one newer than its source and
        headers exists."""
        return build_all([self])[0]

    def fresh(self) -> bool:
        """A built library newer than the source and every header."""
        if not self.path.is_file():
            return False
        built = self.path.stat().st_mtime
        return all(built >= f.stat().st_mtime
                   for f in (self.source, *self.headers))

    def load(self) -> ctypes.CDLL:
        """The built library with its C signatures declared."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build().path))
            for fn, args in self.signatures.items():
                entry = getattr(lib, fn)
                entry.argtypes = [CTYPES[a] for a in args]
                entry.restype = ctypes.c_int
            self._lib = lib
        return self._lib


def build_all(libraries) -> list[BuildInfo]:
    """Build every library that has no library newer than its source and
    headers, one ``nvcc`` per source, all started together; raises after
    all ended if any failed."""
    jobs = []
    for lib in libraries:
        if lib._info is not None:
            continue
        if lib.fresh():
            lib._info = BuildInfo(lib.path, 0.0, "")
            continue
        lib.build_dir.mkdir(exist_ok=True)
        tmp = lib.path.with_suffix(f".so.{os.getpid()}")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(lib.source)]
        jobs.append((lib, tmp, time.perf_counter(),
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)))
    errors = []
    for lib, tmp, t0, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {lib.source.name} "
                          f"({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib.path)  # atomic: concurrent builds race safely
        lib._info = BuildInfo(lib.path, time.perf_counter() - t0, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [lib._info for lib in libraries]

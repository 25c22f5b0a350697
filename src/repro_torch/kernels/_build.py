"""Build and load a kernel's CUDA library at first use.

Each kernel subpackage keeps its sources under ``csrc/`` and describes
them with one :class:`KernelLibrary`: the sources (the forward kernel's,
then its backward's where it has one), the library's name and the C
signatures of its entry points.  ``nvcc`` compiles each source for
``sm_90a`` into an object and links the objects into a shared library
with a plain C interface under the kernel's own ``build/`` (listed in
``.gitignore``), and ``ctypes`` loads it.  Nothing happens at import:
the CPU tests import every kernel module on machines without ``nvcc``.
A build failure raises; there is no fallback.  Every build goes through
:func:`build_all`, which starts one ``nvcc`` per source together, waits
for all of them and then links each library.  Helpers shared by several
kernels (``wgmma``, TMA, ``mbarrier``) live in :data:`HOPPER_HEADER`; a
library is rebuilt when a source or any header it names is newer than
it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

#: flags of each source's compile (``-c``); the link adds ``-shared``
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    """CUDA sources built into ``build/lib<name>.so`` beside them.

    ``sources``: one path, or several that are compiled apart and linked
    into the one library (each with its own ``extern "C"`` entries).
    ``signatures`` maps each C entry point to its argument codes (keys
    of :data:`CTYPES`); every entry point returns an ``int`` error code.
    ``headers`` are the files a source includes from elsewhere in the
    package: an edit of one rebuilds the library.
    """

    def __init__(self, sources, name: str,
                 signatures: dict[str, tuple[str, ...]],
                 headers: tuple = ()):
        self.sources = ((Path(sources),) if isinstance(sources, (str, Path))
                        else tuple(Path(s) for s in sources))
        self.headers = tuple(Path(h) for h in headers)
        self.build_dir = self.sources[0].parent.parent / "build"
        self.path = self.build_dir / f"lib{name}.so"
        self.signatures = signatures
        self._info: BuildInfo | None = None
        self._lib: ctypes.CDLL | None = None

    def build(self) -> BuildInfo:
        """Compile the library unless one newer than its sources and
        headers exists."""
        return build_all([self])[0]

    def fresh(self) -> bool:
        """A built library newer than every source and header."""
        if not self.path.is_file():
            return False
        built = self.path.stat().st_mtime
        return all(built >= f.stat().st_mtime
                   for f in (*self.sources, *self.headers))

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


def _run(cmd: list) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(libraries) -> list[BuildInfo]:
    """Build every library that has no library newer than its sources
    and headers: one ``nvcc -c`` per source, all started together, then
    one link per library; raises after all ended if any failed."""
    nvcc, tag = None, os.getpid()
    jobs = []
    for lib in libraries:
        if lib._info is not None:
            continue
        if lib.fresh():
            lib._info = BuildInfo(lib.path, 0.0, "")
            continue
        nvcc = nvcc or find_nvcc()
        lib.build_dir.mkdir(exist_ok=True)
        objs = [lib.build_dir / f"{src.stem}.{tag}.o" for src in lib.sources]
        procs = [_run([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
                 for src, obj in zip(lib.sources, objs)]
        jobs.append((lib, objs, time.perf_counter(), procs))
    errors = []
    for lib, objs, t0, procs in jobs:
        logs, failed = [], False
        for src, proc in zip(lib.sources, procs):
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode != 0:
                failed = True
                errors.append(f"nvcc failed on {src.name} "
                              f"({proc.returncode}):\n{log}")
        if not failed:
            tmp = lib.path.with_suffix(f".so.{tag}")
            link = _run([nvcc, "-shared", "-o", str(tmp),
                         *map(str, objs)])
            log, _ = link.communicate()
            if link.returncode != 0:
                errors.append(f"nvcc failed to link {lib.path.name} "
                              f"({link.returncode}):\n{log}")
            else:
                os.replace(tmp, lib.path)  # atomic: concurrent builds race
                lib._info = BuildInfo(lib.path, time.perf_counter() - t0,
                                      "".join(logs))
        for obj in objs:
            obj.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [lib._info for lib in libraries]

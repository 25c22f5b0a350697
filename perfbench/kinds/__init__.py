"""The drivers of the two kinds of traffic mix (``train``, ``serve``) and
what they share: the device's clock, memory and build steps, and the
port's model built and filled from the seed."""

from __future__ import annotations

import gc
import statistics
import subprocess
import sys
import time

import torch

from perfbench import spec, weights


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    """Opens the device's context and zeroes its peak of allocated
    memory."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0


def free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def prebuild(dev: torch.device) -> None:
    """Builds the port's kernel libraries together (each in its
    ``build/`` inside the checkout; a fresh library is reused)."""
    if dev.type != "cuda":
        return
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.flash_attention.build import LIB as b2
    from repro_torch.kernels.rmsnorm.build import LIB as b4
    from repro_torch.kernels.ssd_scan.build import LIB as b3
    build_all([b2, b3, b4])


def build_model(cell, seed: int, dev: torch.device):
    """(ModelConfig, the port's module on ``dev`` with the seed's
    weights)."""
    t0 = now()
    cfg = spec.model_config(cell.model)
    model = spec.builder(cell.config)(cfg, device=dev)
    sync(dev)
    t1 = now()
    weights.fill(dict(model.named_parameters()), seed, cell.init)
    sync(dev)
    log(f"module built in {t1 - t0:.3f} s, weights filled in "
        f"{now() - t1:.3f} s")
    model._cw = None
    return cfg, model


class Marks:
    """CUDA events recorded as each unit of the window is issued; once
    the window is synchronised, :meth:`summary` gives the spread of the
    intervals between them (the device's pace unit by unit) and which
    units were slow, the seconds the host spent in Python's garbage
    collections of each generation, the allocator's retries and device
    allocations in the window, and the card's clocks, for the log."""

    def __init__(self, dev: torch.device):
        self.dev, self.events = dev, []
        self.on = dev.type == "cuda"
        self.alloc0 = self._alloc()
        self.gc_s, self._gc_t = [0.0, 0.0, 0.0], 0.0
        gc.callbacks.append(self._gc)

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            self.gc_s[info["generation"]] += time.perf_counter() - self._gc_t

    def _alloc(self) -> tuple:
        if not self.on:
            return (0, 0)
        st = torch.cuda.memory_stats(self.dev)
        return (st.get("num_alloc_retries", 0),
                st.get("num_device_alloc", 0))

    def mark(self) -> None:
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)

    def summary(self) -> str:
        gc.callbacks.remove(self._gc)
        if len(self.events) < 3:
            return "no unit intervals"
        ms = [a.elapsed_time(b)
              for a, b in zip(self.events, self.events[1:])]
        med = statistics.median(ms)
        slow = {i: round(x, 1) for i, x in enumerate(ms) if x > 1.1 * med}
        retries, allocs = (b - a for a, b in zip(self.alloc0,
                                                 self._alloc()))
        gcs = ", ".join(f"{s:.3f}" for s in self.gc_s)
        return (f"unit ms min {min(ms):.2f} median {med:.2f} "
                f"max {max(ms):.2f}, over 1.1x median (unit: ms) {slow}; "
                f"garbage collection s by generation {gcs}; allocator "
                f"retries {retries}, device allocations {allocs}; "
                f"{clocks()}")


def clocks() -> str:
    """The card's SM and memory clocks, power draw and throttle reasons
    now, from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
             "temperature.gpu,clocks_throttle_reasons.active",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return "clocks " + out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "clocks not read"


def now() -> float:
    return time.perf_counter()


def log(msg: str) -> None:
    """A progress line on standard error."""
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)

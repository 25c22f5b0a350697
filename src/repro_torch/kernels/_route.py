"""Which version of a kernel's function a wrapper runs.

Every kernel wrapper asks :func:`launches_kernel` once its inputs are
checked.  Tensors on the CPU (which only the tests pass) get the plain
PyTorch version, which is differentiable.  CUDA tensors get the kernel,
which writes into a fresh tensor through ``ctypes``.  B2 (flash
attention), B3 (the SSD scan) and B4 (RMSNorm) call it inside their
``torch.autograd.Function`` where a gradient is needed, whose backward is
a kernel too, so grad mode is off there and nothing is refused.  B1
(segment sum) has no backward (the simulator never asks for one): where
grad mode is on and an input requires a gradient, its wrappers raise
instead of returning a result without one.  Any other device raises.

The backward wrappers are :func:`observed`: each calls every callable
in :data:`OBSERVERS` with its name and arguments before it runs, so a
caller can record the inputs a train step gives them (chip_smoke holds
the kernels against their plain versions on those) while the wrappers
and their launch counts stay the module's own.
"""

from __future__ import annotations

import functools

import torch

#: callables ``f(name, args, kwargs)``; empty unless a caller adds one
OBSERVERS: list = []


def observed(fn):
    """``fn``, first calling each of :data:`OBSERVERS` with
    ``fn.__name__`` and the call's arguments."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        for observer in OBSERVERS:
            observer(fn.__name__, args, kwargs)
        return fn(*args, **kwargs)
    return call


def device_type(t: torch.Tensor) -> str:
    """The device type a wrapper routes on."""
    return t.device.type


def launches_kernel(name: str, first: torch.Tensor, *others) -> bool:
    """``False`` for ``first`` on the CPU (run the plain version),
    ``True`` for a CUDA tensor (launch the kernel).  Raises for another
    device, and for a CUDA call that would need a gradient through any of
    ``first`` and ``others`` (``None`` entries are skipped), which only a
    kernel without a backward can meet."""
    kind = device_type(first)
    if kind == "cpu":
        return False
    if kind != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (first, *others)):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward yet (ROADMAP A.5), "
            f"and an input requires a gradient; call it under "
            f"torch.no_grad() or on tensors that do not require grad")
    return True

"""Which version of a kernel's function a wrapper runs.

Every kernel wrapper asks :func:`launches_kernel` once its inputs are
checked.  Tensors on the CPU (which only the tests pass) get the plain
PyTorch version, which is differentiable.  CUDA tensors get the kernel,
which writes into a fresh tensor through ``ctypes`` and so has no
backward: where grad mode is on and an input requires a gradient, the
wrapper raises instead of returning a result without one.  Any other
device raises.
"""

from __future__ import annotations

import torch


def device_type(t: torch.Tensor) -> str:
    """The device type a wrapper routes on."""
    return t.device.type


def launches_kernel(name: str, first: torch.Tensor, *others) -> bool:
    """``False`` for ``first`` on the CPU (run the plain version),
    ``True`` for a CUDA tensor (launch the kernel).  Raises for another
    device, and for a CUDA call that would need a gradient through any of
    ``first`` and ``others`` (``None`` entries are skipped)."""
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

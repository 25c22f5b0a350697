"""Device resolution for the PyTorch port.

Counterpart of ``repro/compat/runtime.py``.  The reference degrades to
NumPy when its accelerator stack is missing; the port does not.  Its
entry points run on the CUDA card unless the caller asks for the CPU
explicitly (``device="cpu"``, as the tests do), and a CUDA request on a
machine without CUDA raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch

#: the compute capability the hand-written kernels are built for (sm_90a)
HOPPER = (9, 0)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card.  Raises if CUDA is requested but
    absent; ``"cpu"`` is honoured as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_hopper(device=None) -> bool:
    """True when the (default) CUDA device has compute capability 9.0."""
    if not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(device) == HOPPER

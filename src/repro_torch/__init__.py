"""PyTorch/CUDA port of the Dragonfly application-aware routing system.

``repro`` (JAX) is the reference; this package mirrors its layout
(``core``, ``dragonfly``, ``faults``, ``kernels``) and imports nothing
of it, nor jax.  Modules that are NumPy-only in the reference are kept
here as copies.  Entry points run on the CUDA card unless the caller
passes ``device="cpu"`` (:mod:`repro_torch.runtime`).  All randomness
is drawn on the host from NumPy generators, draw for draw with the
reference; the phase pipeline computes in float32.
"""

from repro_torch.runtime import on_hopper, resolve_device

__all__ = ["on_hopper", "resolve_device"]

"""Batched serving engine of the port (counterpart of ``repro.serve``)."""

from repro_torch.serve.engine import (Request, ServeConfig, ServeEngine,
                                      make_prefill, make_serve_step)

__all__ = ["Request", "ServeConfig", "ServeEngine", "make_prefill",
           "make_serve_step"]

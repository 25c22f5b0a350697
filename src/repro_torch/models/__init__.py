"""Model stack of the port: configuration, layers, the Mamba2 SSM
language model, the dense transformer and the family registry
(counterpart of ``repro.models``)."""

from repro_torch.models.common import Family, ModelConfig
from repro_torch.models.registry import (decode_step, init_params,
                                         make_decode_state, prefill,
                                         train_forward)

__all__ = ["Family", "ModelConfig", "decode_step", "init_params",
           "make_decode_state", "prefill", "train_forward"]

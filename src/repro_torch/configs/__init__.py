# repro_torch.configs — the ported architectures (exact published dims),
# the input-shape sets and the registry used by --arch <id> flags.

from repro_torch.configs.registry import (ARCHS, PORTED, get_config,
                                          get_smoke_config, list_archs)
from repro_torch.configs.shapes import (SHAPES, InputShape,
                                        ShapeNotSupported, check_supported,
                                        input_specs)

__all__ = ["ARCHS", "PORTED", "get_config", "get_smoke_config", "list_archs",
           "SHAPES", "InputShape", "ShapeNotSupported", "input_specs",
           "check_supported"]

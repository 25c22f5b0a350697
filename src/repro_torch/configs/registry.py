"""--arch <id> registry over the reference's 10 architectures.

All ten are ported: mamba2-130m, the four dense archs (qwen2-1.5b,
stablelm-1.6b, llama3-8b, codeqwen1.5-7b), the two MoE archs
(granite-moe-3b-a800m, qwen2-moe-a2.7b), the hybrid zamba2-7b, the
enc-dec whisper-large-v3 and the VLM paligemma-3b.  An id outside the
ten raises ``KeyError``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

_MODULES = {
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen15_7b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
}

ARCHS = ("paligemma-3b", "stablelm-1.6b", "llama3-8b", "codeqwen1.5-7b",
         "qwen2-1.5b", "granite-moe-3b-a800m", "qwen2-moe-a2.7b",
         "zamba2-7b", "mamba2-130m", "whisper-large-v3")
PORTED = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCHS)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def list_archs() -> tuple:
    """Every architecture id, in the reference's order."""
    return ARCHS

"""--arch <id> registry over the reference's 10 architectures.

Only mamba2-130m is ported; asking for any other of the ten raises
``NotImplementedError`` pointing to its ROADMAP item, and an id outside
the ten raises ``KeyError``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

_MODULES = {
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
}

#: the reference's architectures that are not ported yet, with where
#: each is queued
PENDING = {
    "paligemma-3b": "ROADMAP A.4 (VLM family, after flash attention B2)",
    "stablelm-1.6b": "ROADMAP A.4 (dense serving slice with B2)",
    "llama3-8b": "ROADMAP A.4 (dense serving slice with B2)",
    "codeqwen1.5-7b": "ROADMAP A.4 (dense serving slice with B2)",
    "qwen2-1.5b": "ROADMAP A.4 (dense serving slice with B2)",
    "granite-moe-3b-a800m": "ROADMAP A.4 (MoE family, after collectives)",
    "qwen2-moe-a2.7b": "ROADMAP A.4 (MoE family, after collectives)",
    "zamba2-7b": "ROADMAP A.4 (hybrid family, after B2)",
    "whisper-large-v3": "ROADMAP A.4 (enc-dec family, after B2)",
}

ARCHS = ("paligemma-3b", "stablelm-1.6b", "llama3-8b", "codeqwen1.5-7b",
         "qwen2-1.5b", "granite-moe-3b-a800m", "qwen2-moe-a2.7b",
         "zamba2-7b", "mamba2-130m", "whisper-large-v3")
PORTED = tuple(_MODULES)


def _module(arch: str):
    if arch in PENDING:
        raise NotImplementedError(
            f"{arch} is not ported to repro_torch yet; see {PENDING[arch]}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCHS)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE

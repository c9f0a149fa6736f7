"""Configuration (the port's copy of ``repro.configs``).

``get_config``/``get_smoke_config``/``list_archs`` cover the archs the
port runs so far: the dense, ssm and hybrid families. Every other arch
id of the JAX package raises ``NotImplementedError`` naming the ROADMAP
item that brings its family (``base.UNPORTED_FAMILIES``).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    EncoderConfig,
    InputShape,
    ModelConfig,
    MoEConfig,
    RecurrentConfig,
    SSMConfig,
    VLMConfig,
    require_ported,
)

# arch id -> module name, the archs the port runs
_ARCH_MODULES: Dict[str, str] = {
    "command-r-35b": "command_r_35b",
    "mamba2-1.3b": "mamba2_1_3b",
    "mistral-large-123b": "mistral_large_123b",
    "nemotron-4-340b": "nemotron_4_340b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "stablelm-12b": "stablelm_12b",
}

# arch id -> model family, the JAX package's archs the port does not run
_UNPORTED_ARCHS: Dict[str, str] = {
    "qwen3-moe-30b-a3b": "moe",
    "mixtral-8x22b": "moe",
    "whisper-large-v3": "audio",
    "internvl2-2b": "vlm",
}


def list_archs() -> List[str]:
    return sorted(_ARCH_MODULES)


def _module(arch: str):
    if arch in _UNPORTED_ARCHS:
        require_ported(_UNPORTED_ARCHS[arch])
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {list_archs()}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    """Full published config for ``--arch <id>``."""
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests."""
    return _module(arch).smoke_config()

"""Configuration (the port's copy of ``repro.configs``).

``get_config``/``get_smoke_config``/``list_archs`` cover every arch of
the JAX package: the dense, moe, ssm, hybrid, audio and vlm families.
``SHAPE_SKIPS`` names the (arch, shape) pairs the dry-run skips by
design, as the JAX package's does.
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
)

# arch id -> module name
_ARCH_MODULES: Dict[str, str] = {
    "command-r-35b": "command_r_35b",
    "internvl2-2b": "internvl2_2b",
    "mamba2-1.3b": "mamba2_1_3b",
    "mistral-large-123b": "mistral_large_123b",
    "mixtral-8x22b": "mixtral_8x22b",
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "stablelm-12b": "stablelm_12b",
    "whisper-large-v3": "whisper_large_v3",
}


# (arch, shape) pairs that are skipped by design (the JAX package's
# DESIGN.md §9)
SHAPE_SKIPS = {
    ("whisper-large-v3", "long_500k"):
        "enc-dec ASR; decoder capped at 448 tokens — 524k-token decode "
        "context is meaningless for the family",
}


def list_archs() -> List[str]:
    return sorted(_ARCH_MODULES)


def _module(arch: str):
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


def shape_is_supported(arch: str, shape: str) -> bool:
    return (arch, shape) not in SHAPE_SKIPS

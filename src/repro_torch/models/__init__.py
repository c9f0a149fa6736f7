"""Model registry: family -> module (counterpart of ``repro.models``).

Every family of the JAX package is ported: dense, moe, ssm, hybrid,
audio (whisper) and vlm. The functions take the model module where the
JAX package takes its parameter tree; ``forward`` and ``prefill`` pass
the audio and vlm families the whole batch dict (their frame or patch
embeddings beside the tokens), the others its tokens.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_FAMILY_MODULES = {"dense": "dense", "moe": "moe", "ssm": "ssm",
                   "hybrid": "hybrid", "audio": "whisper", "vlm": "vlm"}
# families whose forward and prefill take the whole batch dict
_BATCH_FAMILIES = ("audio", "vlm")


def get_module(cfg: ModelConfig):
    if cfg.family not in _FAMILY_MODULES:
        raise KeyError(f"unknown model family {cfg.family!r}")
    return importlib.import_module(
        f"repro_torch.models.{_FAMILY_MODULES[cfg.family]}")


def init(cfg: ModelConfig, seed: int = 0, *, device=None):
    """Random parameters from ``seed`` on ``device`` (default: the
    current CUDA device; raises without one)."""
    return get_module(cfg).init(cfg, seed, device=device)


def count_params(cfg: ModelConfig) -> int:
    from repro_torch.models import common
    return common.count_params(get_module(cfg).param_defs(cfg))


def forward(cfg: ModelConfig, params, batch):
    mod = get_module(cfg)
    if cfg.family in _BATCH_FAMILIES:
        return mod.forward(cfg, params, batch)
    return mod.forward(cfg, params, batch["tokens"])


def loss_fn(cfg: ModelConfig, params, batch):
    """Mean next-token CE of ``batch`` (float32, 0-d, differentiable;
    the moe adds its load-balance loss) through the family's training
    route: attention's plain path, the ssm's plain intra-chunk term,
    the hybrid's ``lru_scan`` kernel with its backward on the card."""
    return get_module(cfg).loss_fn(cfg, params, batch)


def prefill(cfg: ModelConfig, params, batch, pad_to: int = 0):
    mod = get_module(cfg)
    if cfg.family in _BATCH_FAMILIES:
        return mod.prefill(cfg, params, batch, pad_to=pad_to)
    return mod.prefill(cfg, params, batch["tokens"], pad_to=pad_to)


def serve_step(cfg: ModelConfig, params, cache, tokens):
    return get_module(cfg).serve_step(cfg, params, cache, tokens)


def init_decode_cache(cfg: ModelConfig, batch: int, context_len: int, *,
                      device=None):
    return get_module(cfg).init_decode_cache(cfg, batch, context_len,
                                             device=device)

"""Model registry: family -> module (counterpart of ``repro.models``).

The port runs and trains (:func:`loss_fn`) the dense, ssm and hybrid
families so far. Every other family raises
``NotImplementedError`` naming the ROADMAP item that brings it
(``configs.base.UNPORTED_FAMILIES``). The functions take the
model module where the JAX package takes its parameter tree.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, require_ported

_FAMILY_MODULES = {"dense": "dense", "ssm": "ssm", "hybrid": "hybrid"}


def get_module(cfg: ModelConfig):
    require_ported(cfg.family)
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
    return get_module(cfg).forward(cfg, params, batch["tokens"])


def loss_fn(cfg: ModelConfig, params, batch):
    """Mean next-token CE of ``batch`` (float32, 0-d, differentiable)
    through the family's training route: attention's plain path, the
    ssm's plain intra-chunk term, the hybrid's ``lru_scan`` kernel with
    its backward on the card."""
    return get_module(cfg).loss_fn(cfg, params, batch)


def prefill(cfg: ModelConfig, params, batch, pad_to: int = 0):
    return get_module(cfg).prefill(cfg, params, batch["tokens"],
                                   pad_to=pad_to)


def serve_step(cfg: ModelConfig, params, cache, tokens):
    return get_module(cfg).serve_step(cfg, params, cache, tokens)


def init_decode_cache(cfg: ModelConfig, batch: int, context_len: int, *,
                      device=None):
    return get_module(cfg).init_decode_cache(cfg, batch, context_len,
                                             device=device)

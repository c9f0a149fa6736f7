"""Model registry: family -> module (counterpart of ``repro.models``).

The port runs the dense, ssm and hybrid families so far, and trains
the dense family (:func:`loss_fn`). Every other family raises
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


# families whose loss the port can differentiate on the card
_TRAINED_FAMILIES = ("dense",)


def loss_fn(cfg: ModelConfig, params, batch):
    """Mean next-token CE of ``batch`` (float32, 0-d, differentiable).
    The dense family only: the ssm and hybrid forwards run the
    ``ssd_chunk`` and ``lru_scan`` kernels, which have no backward."""
    module = get_module(cfg)
    if cfg.family not in _TRAINED_FAMILIES:
        raise NotImplementedError(
            f"loss_fn of the {cfg.family!r} family is not ported yet: it "
            f"comes with training for the ssm and hybrid families "
            f"(ROADMAP.md, queue 1)")
    return module.loss_fn(cfg, params, batch)


def prefill(cfg: ModelConfig, params, batch, pad_to: int = 0):
    return get_module(cfg).prefill(cfg, params, batch["tokens"],
                                   pad_to=pad_to)


def serve_step(cfg: ModelConfig, params, cache, tokens):
    return get_module(cfg).serve_step(cfg, params, cache, tokens)


def init_decode_cache(cfg: ModelConfig, batch: int, context_len: int, *,
                      device=None):
    return get_module(cfg).init_decode_cache(cfg, batch, context_len,
                                             device=device)

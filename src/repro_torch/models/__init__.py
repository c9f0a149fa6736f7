"""Model registry: family -> module (counterpart of ``repro.models``).

Every family of the JAX package is ported: dense, moe, ssm, hybrid,
audio (whisper) and vlm. The functions take the model module where the
JAX package takes its parameter tree; ``forward`` and ``prefill`` pass
the audio and vlm families the whole batch dict (their frame or patch
embeddings beside the tokens), the others its tokens. The dry-run's
helpers (:func:`abstract_params`, :func:`abstract_model`,
:func:`input_specs`, the logical specs, ``init_decode_cache(...,
abstract=True)``) give meta tensors: shapes and types, no storage.
"""
from __future__ import annotations

import importlib

import torch

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


def abstract_params(cfg: ModelConfig):
    """The parameter tree as meta tensors (the JAX package's
    ShapeDtypeStruct tree: stacked layer leaves, no allocation)."""
    from repro_torch.models import common
    return common.abstract(get_module(cfg).param_defs(cfg), cfg.dtype)


def param_logical_specs(cfg: ModelConfig):
    from repro_torch.models import common
    return common.logical_specs(get_module(cfg).param_defs(cfg))


def abstract_model(cfg: ModelConfig, *, requires_grad: bool = False):
    """The family's model module on the meta device, its parameters
    left empty (no draws: ``init``'s counter-based normals need a
    device with data), gradients on when ``requires_grad`` as in a
    train state. The dry-run runs a step through it."""
    return get_module(cfg).LM(cfg, device="meta").requires_grad_(
        requires_grad)


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
                      device=None, abstract: bool = False):
    return get_module(cfg).init_decode_cache(cfg, batch, context_len,
                                             device=device,
                                             abstract=abstract)


def cache_logical_specs(cfg: ModelConfig):
    from repro_torch.models import attention
    mod = get_module(cfg)
    if hasattr(mod, "cache_logical_specs"):
        return mod.cache_logical_specs()
    return attention.cache_logical_specs()


def input_specs(cfg: ModelConfig, batch: int, seq_len: int,
                kind: str) -> dict:
    """Meta tensors for one step's inputs (the JAX package's
    ShapeDtypeStructs).

    ``kind``: train | prefill -> the full batch dict; decode -> one
    token (the cache comes from ``init_decode_cache(abstract=True)``).
    For audio/vlm the stubbed frontend's frame/patch embeddings stand
    beside the tokens, and ``seq_len`` covers frontend and text
    tokens."""
    def s(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    from repro_torch.models import common
    f = common.torch_dtype(cfg.dtype)
    if kind == "decode":
        return {"tokens": s((batch, 1), i32)}
    if cfg.family == "audio":
        F_ = cfg.encoder.n_frontend_tokens
        dec = max(seq_len - F_, 8)
        return {"audio_embeds": s((batch, F_, cfg.d_model), f),
                "tokens": s((batch, dec), i32)}
    if cfg.family == "vlm":
        nv = cfg.vlm.n_visual_tokens
        txt = max(seq_len - nv, 8)
        return {"visual_embeds": s((batch, nv, cfg.vlm.d_visual), f),
                "tokens": s((batch, txt), i32)}
    return {"tokens": s((batch, seq_len), i32)}

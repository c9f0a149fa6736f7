"""Deterministic synthetic token batches (counterpart of
``repro.data.pipeline``).

Batch ``step`` of any (cfg, seed) is a pure function of (seed, step):
its generator is seeded from both, so a resumed job continues the
stream with no drift. Tokens follow a Zipf(1) law over the vocabulary,
drawn by the JAX package's inverse-CDF rule; the numbers differ from
``jax.random``'s.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig, require_ported


def _zipf_tokens(gen: torch.Generator, shape, vocab: int,
                 device) -> torch.Tensor:
    """Zipf(1.0)-distributed token ids via inverse-CDF on u ~ U[1e-6, 1)."""
    u = torch.rand(shape, generator=gen, device=device) * (1.0 - 1e-6) + 1e-6
    # rank ~ exp(u * log V) gives p(rank) ~ 1/rank
    r = torch.exp(u * math.log(float(vocab))) - 1.0
    return r.to(torch.int32).clamp(0, vocab - 1)


def make_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int,
               step: int, *, device=None) -> dict:
    """One batch of ``tokens`` (batch, seq_len) int32 for a token-only
    family, on ``device`` (default: the current CUDA device)."""
    if cfg.family in ("audio", "vlm"):     # batches with embeddings
        require_ported(cfg.family)
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev)
    state = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    gen.manual_seed(int(state))
    return {"tokens": _zipf_tokens(gen, (batch, seq_len), cfg.vocab, dev)}


def make_eval_batch(cfg: ModelConfig, batch: int, seq_len: int,
                    seed: int = 1234, *, device=None) -> dict:
    """A fixed held-out batch: batch 0 of ``seed``."""
    return make_batch(cfg, batch, seq_len, seed, step=0, device=device)

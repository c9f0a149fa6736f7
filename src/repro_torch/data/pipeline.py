"""Deterministic synthetic token batches (counterpart of
``repro.data.pipeline``).

Batch ``step`` of any (cfg, seed) is a pure function of (seed, step):
its generator is seeded from both, so a resumed job continues the
stream with no drift. Everything is drawn on the CPU, whatever the
target device, and copied there, so the card gets the CPU's values bit
for bit (a CUDA generator's stream differs from the CPU's). Tokens
follow a Zipf(1) law over the vocabulary, drawn by the JAX package's
inverse-CDF rule. The audio and vlm families' stub embeddings
(``audio_embeds`` (B, F, d_model), ``visual_embeds`` (B, n_visual,
d_visual)) are standard normals (``draws.normals``, keyed by seed and
step) cast to the model's type and scaled by 0.3 there, as in JAX; the
numbers differ from ``jax.random``'s.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import draws
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common


def _zipf_tokens(gen: torch.Generator, shape, vocab: int) -> torch.Tensor:
    """Zipf(1.0)-distributed token ids via inverse-CDF on u ~ U[1e-6, 1),
    on the CPU generator ``gen``."""
    u = torch.rand(shape, generator=gen) * (1.0 - 1e-6) + 1e-6
    # rank ~ exp(u * log V) gives p(rank) ~ 1/rank
    r = torch.exp(u * math.log(float(vocab))) - 1.0
    return r.to(torch.int32).clamp(0, vocab - 1)


# the embedding draw's word in its key, beside (seed, step)
_EMBED_DRAW = 1


def _embeddings(seed: int, step: int, shape, dtype: torch.dtype
                ) -> torch.Tensor:
    """Standard normals of ``shape`` on the CPU (counter-based, keyed by
    (seed, step)), cast to ``dtype`` and scaled by 0.3 in it."""
    n = int(np.prod(shape))
    x = draws.normals(draws.key(seed, step, _EMBED_DRAW), 0, n, "cpu")
    return x.to(dtype).reshape(shape) * 0.3


def make_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int,
               step: int, *, device=None) -> dict:
    """One batch on ``device`` (default: the current CUDA device), drawn
    on the CPU and copied: ``tokens`` (batch, seq_len) int32, and for
    the audio and vlm families their stub embeddings, ``seq_len``
    counting them as in JAX: ``max(seq_len - F, 8)`` decoder tokens
    after F frames, ``max(seq_len - n_visual, 8)`` text tokens after the
    visual ones."""
    dev = _device.resolve(device)
    gen = torch.Generator()
    state = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    gen.manual_seed(int(state))
    dtype = common.torch_dtype(cfg.dtype)
    if cfg.family == "audio":
        F_ = cfg.encoder.n_frontend_tokens
        return {"audio_embeds": _embeddings(
                    seed, step, (batch, F_, cfg.d_model), dtype).to(dev),
                "tokens": _zipf_tokens(gen, (batch, max(seq_len - F_, 8)),
                                       cfg.vocab).to(dev)}
    if cfg.family == "vlm":
        nv = cfg.vlm.n_visual_tokens
        return {"visual_embeds": _embeddings(
                    seed, step, (batch, nv, cfg.vlm.d_visual), dtype).to(dev),
                "tokens": _zipf_tokens(gen, (batch, max(seq_len - nv, 8)),
                                       cfg.vocab).to(dev)}
    return {"tokens": _zipf_tokens(gen, (batch, seq_len), cfg.vocab).to(dev)}


def make_eval_batch(cfg: ModelConfig, batch: int, seq_len: int,
                    seed: int = 1234, *, device=None) -> dict:
    """A fixed held-out batch: batch 0 of ``seed``."""
    return make_batch(cfg, batch, seq_len, seed, step=0, device=device)

"""Whisper-large-v3 [audio]: encoder-decoder transformer backbone
(counterpart of ``repro.models.whisper``).

The mel-spectrogram and conv feature extractor are the one allowed
stub: ``make_batch`` supplies frame embeddings (B, 1500, 1280) straight
to the encoder. The rest is real: a 32-layer encoder, a 32-layer
decoder with causal self-attention and cross-attention on the encoder
output, LayerNorm with biases, biased q/v/o projections and an
unbiased k, a plain GELU MLP, the tied unembedding. Positions are
sinusoidal in both stacks (as in the JAX package, where real Whisper
has a learned 448-entry decoder table).

:class:`WhisperLM` keeps one submodule per layer of each stack
(``enc``, ``dec``) and the unstacked ``embed`` and final LayerNorms in
``top``. Attention routes: the decoder's causal self-attention passes
``attend`` its hint (the flash kernel on the card for a prompt); the
encoder's bidirectional self-attention and the cross-attention over
the 1,500 frames pass none and take the plain path by route (the flash
wrapper refuses non-causal lengths that are not multiples of 128, as
the JAX one does, and the JAX model runs its jnp path there). Training
(:func:`loss_fn`) passes no hint anywhere.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, dense
from repro_torch.models.common import ParamDef


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(n,) positions -> (n, d) float32 [sin | cos] table; the frequency
    step ``log(10000) / max(half - 1, 1)`` in float32, as in JAX."""
    half = d // 2
    step = torch.log(torch.tensor(10000.0)) / max(half - 1, 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32)
                      * step).to(positions.device)
    ang = positions[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _ln_defs(L: int, D: int, name: str) -> dict:
    return {
        f"{name}_g": ParamDef((L, D), ("layers", "embed"), init="ones"),
        f"{name}_b": ParamDef((L, D), ("layers", "embed"), init="zeros"),
    }


def _attn_defs(cfg: ModelConfig, L: int, prefix: str) -> dict:
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        f"{prefix}_wq": ParamDef((L, D, H, hd), ("layers", "embed", "heads", "head_dim")),
        f"{prefix}_bq": ParamDef((L, H, hd), ("layers", "heads", "head_dim"), init="zeros"),
        f"{prefix}_wk": ParamDef((L, D, H, hd), ("layers", "embed", "heads", "head_dim")),
        f"{prefix}_wv": ParamDef((L, D, H, hd), ("layers", "embed", "heads", "head_dim")),
        f"{prefix}_bv": ParamDef((L, H, hd), ("layers", "heads", "head_dim"), init="zeros"),
        f"{prefix}_wo": ParamDef((L, H, hd, D), ("layers", "heads", "head_dim", "embed")),
        f"{prefix}_bo": ParamDef((L, D), ("layers", "embed"), init="zeros"),
    }


def _mlp_defs(cfg: ModelConfig, L: int) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_up": ParamDef((L, D, F), ("layers", "embed", "mlp")),
        "b_up": ParamDef((L, F), ("layers", "mlp"), init="zeros"),
        "w_down": ParamDef((L, F, D), ("layers", "mlp", "embed")),
        "b_down": ParamDef((L, D), ("layers", "embed"), init="zeros"),
    }


def param_defs(cfg: ModelConfig) -> dict:
    D, V = cfg.d_model, cfg.vocab
    Le, Ld = cfg.encoder.n_layers, cfg.n_layers
    enc = {**_ln_defs(Le, D, "ln1"), **_attn_defs(cfg, Le, "self"),
           **_ln_defs(Le, D, "ln2"), **_mlp_defs(cfg, Le)}
    dec = {**_ln_defs(Ld, D, "ln1"), **_attn_defs(cfg, Ld, "self"),
           **_ln_defs(Ld, D, "ln2"), **_attn_defs(cfg, Ld, "cross"),
           **_ln_defs(Ld, D, "ln3"), **_mlp_defs(cfg, Ld)}
    return {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=0.02),
        "enc": enc,
        "dec": dec,
        "enc_ln_g": ParamDef((D,), ("embed",), init="ones"),
        "enc_ln_b": ParamDef((D,), ("embed",), init="zeros"),
        "dec_ln_g": ParamDef((D,), ("embed",), init="ones"),
        "dec_ln_b": ParamDef((D,), ("embed",), init="zeros"),
    }


class WhisperLM(nn.Module):
    """``top`` (embed (V, D) and the two final LayerNorms), ``enc`` and
    ``dec``: one leaf module per layer of each stack. Allocated empty;
    :func:`init` or ``convert.params_from_numpy`` fills it."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = common.torch_dtype(cfg.dtype)
        defs = param_defs(cfg)
        top = {k: d for k, d in defs.items() if isinstance(d, ParamDef)}
        self.top = dense._Leaves(top, dtype, device, stacked=False)
        self.enc = nn.ModuleList(
            dense._Leaves(defs["enc"], dtype, device, stacked=True)
            for _ in range(cfg.encoder.n_layers))
        self.dec = nn.ModuleList(
            dense._Leaves(defs["dec"], dtype, device, stacked=True)
            for _ in range(cfg.n_layers))

    def leaf(self, name: str, layer: Optional[int] = None,
             stack: str = "dec") -> nn.Parameter:
        """The parameter of ParamDef ``name``; ``layer`` picks the slice
        of a leaf of ``stack`` ("enc" or "dec")."""
        if layer is None:
            return getattr(self.top, name)
        return getattr(getattr(self, stack)[layer], name)


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, *, device=None) -> WhisperLM:
    """Random parameters with the JAX package's initializers (LayerNorm
    gains ones, biases zeros), drawn leaf by leaf by
    ``dense.init_leaves`` from ``seed``, the same bits on every device;
    the numbers differ from ``jax.random``'s."""
    dev = _device.resolve(device)
    return dense.init_leaves(WhisperLM(cfg, device=dev), param_defs(cfg),
                             seed, dev)


# ---------------------------------------------------------------------------
# Blocks (LayerNorm + biased projections, Whisper-style)
# ---------------------------------------------------------------------------

def _ln(cfg: ModelConfig, lp: nn.Module, name: str,
        x: torch.Tensor) -> torch.Tensor:
    return common.layer_norm(x, getattr(lp, f"{name}_g"),
                             getattr(lp, f"{name}_b"), cfg.norm_eps)


def _heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h (B, S, D) @ w (D, H, hd) -> (B, S, H, hd)."""
    B, S, D = h.shape
    return (h @ w.reshape(D, -1)).reshape(B, S, *w.shape[1:])


def _proj_q(lp, prefix, h):
    return _heads(h, getattr(lp, f"{prefix}_wq")) + getattr(lp, f"{prefix}_bq")


def _proj_kv(lp, prefix, h):
    k = _heads(h, getattr(lp, f"{prefix}_wk"))
    v = _heads(h, getattr(lp, f"{prefix}_wv")) + getattr(lp, f"{prefix}_bv")
    return k, v


def _attn_out(lp, prefix, o):
    B, S = o.shape[:2]
    wo = getattr(lp, f"{prefix}_wo")
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1]) \
        + getattr(lp, f"{prefix}_bo")


def _mlp_post(cfg, lp, h):
    act = common.activate(h @ lp.w_up + lp.b_up, cfg.activation)
    return act @ lp.w_down + lp.b_down


def _enc_layer(cfg, lp, x):
    h = _ln(cfg, lp, "ln1", x)
    q, (k, v) = _proj_q(lp, "self", h), _proj_kv(lp, "self", h)
    S = x.shape[1]
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device)
    x = x + _attn_out(lp, "self", attention.attend(q, k, v, mask=mask))
    return x + _mlp_post(cfg, lp, _ln(cfg, lp, "ln2", x))


def encode(cfg: ModelConfig, model: WhisperLM, audio_embeds: torch.Tensor,
           *, train: bool = False) -> torch.Tensor:
    """audio_embeds (B, F, D), the stub's frame embeddings -> the
    encoder's output (B, F, D)."""
    F_, D = audio_embeds.shape[1:]
    x = audio_embeds.to(common.torch_dtype(cfg.dtype))
    x = x + _sinusoid(torch.arange(F_, device=x.device), D).to(x.dtype)[None]
    body = dense._maybe_remat(cfg, _enc_layer) if train else _enc_layer
    for lp in model.enc:
        x = body(cfg, lp, x)
    return common.layer_norm(x, model.top.enc_ln_g, model.top.enc_ln_b,
                             cfg.norm_eps)


def _dec_layer(cfg, lp, x, enc_out, mask, hints):
    """-> (x, (k, v, cross_k, cross_v))."""
    h = _ln(cfg, lp, "ln1", x)
    q, (k, v) = _proj_q(lp, "self", h), _proj_kv(lp, "self", h)
    x = x + _attn_out(lp, "self",
                      attention.attend(q, k, v, mask=mask, **hints))
    h = _ln(cfg, lp, "ln2", x)
    cq, (ck, cv) = _proj_q(lp, "cross", h), _proj_kv(lp, "cross", enc_out)
    cmask = torch.ones((x.shape[1], enc_out.shape[1]), dtype=torch.bool,
                       device=x.device)
    x = x + _attn_out(lp, "cross", attention.attend(cq, ck, cv, mask=cmask))
    x = x + _mlp_post(cfg, lp, _ln(cfg, lp, "ln3", x))
    return x, (k, v, ck, cv)


def _dec_out(cfg, lp, x, enc_out, mask, hints):
    return _dec_layer(cfg, lp, x, enc_out, mask, hints)[0]


def _embed_tokens(cfg, model, tokens, positions):
    x = dense.embed(cfg, model, tokens)
    return x + _sinusoid(positions, cfg.d_model).to(x.dtype)[None]


def _unembed(cfg, model, x):
    x = common.layer_norm(x, model.top.dec_ln_g, model.top.dec_ln_b,
                          cfg.norm_eps)
    return x @ model.top.embed.t()


def decode_train(cfg: ModelConfig, model: WhisperLM, enc_out: torch.Tensor,
                 tokens: torch.Tensor, *, train: bool = False
                 ) -> torch.Tensor:
    """The decoder over ``tokens`` (B, S) -> logits (B, S, V)."""
    S = tokens.shape[1]
    x = _embed_tokens(cfg, model, tokens,
                      torch.arange(S, device=tokens.device))
    mask = common.causal_mask(S, S, device=x.device)
    hints = {} if train else {"causal": True}
    body = dense._maybe_remat(cfg, _dec_out) if train else _dec_out
    for lp in model.dec:
        x = body(cfg, lp, x, enc_out, mask, hints)
    return _unembed(cfg, model, x)


@torch.no_grad()
def forward(cfg: ModelConfig, model: WhisperLM, batch: dict) -> torch.Tensor:
    enc_out = encode(cfg, model, batch["audio_embeds"])
    return decode_train(cfg, model, enc_out, batch["tokens"])


def loss_fn(cfg: ModelConfig, model: WhisperLM, batch: dict) -> torch.Tensor:
    """Mean next-token CE of the decoder tokens, float32 0-d,
    differentiable through the training route."""
    enc_out = encode(cfg, model, batch["audio_embeds"], train=True)
    logits = decode_train(cfg, model, enc_out, batch["tokens"], train=True)
    return common.cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, context_len: int, *,
                      device=None) -> dict:
    """The self-attention cache (k, v over ``context_len`` slots) and the
    cross-attention k/v over the encoder's frames."""
    L, H, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    F_ = cfg.encoder.n_frontend_tokens
    dev = _device.resolve(device)
    cache = attention.init_cache(L, batch, context_len, H, hd,
                                 common.torch_dtype(cfg.dtype), device=dev)
    for name in ("cross_k", "cross_v"):
        cache[name] = torch.zeros((L, batch, F_, H, hd),
                                  dtype=common.torch_dtype(cfg.dtype),
                                  device=dev)
    return cache


@torch.no_grad()
def prefill(cfg: ModelConfig, model: WhisperLM, batch: dict,
            pad_to: int = 0) -> Tuple[torch.Tensor, dict]:
    """Encode the audio and run the decoder over the prompt tokens,
    building both caches; (the last position's logits, cache)."""
    enc_out = encode(cfg, model, batch["audio_embeds"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_tokens(cfg, model, tokens,
                      torch.arange(S, device=tokens.device))
    mask = common.causal_mask(S, S, device=x.device)
    cache = attention.init_cache(cfg.n_layers, B, max(pad_to, S),
                                 cfg.n_kv_heads, cfg.head_dim, x.dtype,
                                 device=x.device)
    cross = []
    for li, lp in enumerate(model.dec):
        x, (k, v, ck, cv) = _dec_layer(cfg, lp, x, enc_out, mask,
                                       {"causal": True})
        cache["k"][li, :, :S] = k
        cache["v"][li, :, :S] = v
        cross.append((ck, cv))
    cache["cross_k"] = torch.stack([c[0] for c in cross])
    cache["cross_v"] = torch.stack([c[1] for c in cross])
    cache["kv_pos"][:S] = torch.arange(S, dtype=torch.int32, device=x.device)
    cache["next_pos"] = S
    return _unembed(cfg, model, x[:, -1:]), cache


@torch.no_grad()
def serve_step(cfg: ModelConfig, model: WhisperLM, cache: dict,
               tokens: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """One decoder token against the self-attention cache and the
    cross-attention k/v; the cache is updated in place and returned."""
    pos = cache["next_pos"]
    x = _embed_tokens(cfg, model, tokens,
                      torch.full((1,), pos, device=tokens.device))
    slot = pos
    if not 0 <= slot < cache["k"].shape[2]:
        raise IndexError(f"decode position {pos} outside a cache of "
                         f"{cache['k'].shape[2]} slots (the cache is full)")
    cache["kv_pos"][slot] = pos
    mask = attention.decode_mask(pos, cache["kv_pos"])
    cmask = torch.ones((1, cache["cross_k"].shape[2]), dtype=torch.bool,
                       device=x.device)
    for li, lp in enumerate(model.dec):
        h = _ln(cfg, lp, "ln1", x)
        q, (k, v) = _proj_q(lp, "self", h), _proj_kv(lp, "self", h)
        k_l, v_l = attention.update_layer_cache(cache["k"][li],
                                                cache["v"][li], k, v, slot)
        x = x + _attn_out(lp, "self", attention.attend(q, k_l, v_l,
                                                       mask=mask))
        cq = _proj_q(lp, "cross", _ln(cfg, lp, "ln2", x))
        x = x + _attn_out(lp, "cross", attention.attend(
            cq, cache["cross_k"][li], cache["cross_v"][li], mask=cmask))
        x = x + _mlp_post(cfg, lp, _ln(cfg, lp, "ln3", x))
    cache["next_pos"] = pos + 1
    return _unembed(cfg, model, x), cache

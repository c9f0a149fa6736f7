"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local
MQA (counterpart of ``repro.models.hybrid``).

The block pattern ``(rec, rec, attn)`` repeats (2:1), and a remainder
of the pattern closes the stack; every residual block is followed by a
GeGLU MLP. The RG-LRU recurrence runs through ``kernels.ops.lru_scan``
(the ``lru_scan`` kernel on the card; the JAX package takes an
associative scan) for the full sequence, and one step at a time in
decode. The attention blocks are the dense family's, run with
``window=local_window``, so on the card a prefill takes the flash
kernel's window path; decode keeps a ring cache of the window size.

:class:`HybridLM` keeps one submodule per layer, in the order of the
pattern: a :class:`RecLayer` (:class:`RecMixer` and a dense MLP) or an
:class:`AttnLayer` (dense attention and MLP), with the JAX package's
per-layer layouts (gate matrices block-diagonal, ``w_a``/``w_i``
(n_heads, R/n_heads, R/n_heads)). The JAX package stacks the recurrent
and the attention layers' leaves on two leading axes (``rec`` and
``attn``) and scans over groups. Not ported: ``loss_fn`` (the training
slice) and the sharding constraints.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention, common, dense
from repro_torch.models.common import ParamDef
from repro_torch.models.ssm import causal_conv, conv_step

_LRU_C = 8.0


def layer_layout(cfg: ModelConfig):
    """-> (n_groups, remainder_pattern, n_rec, n_attn)."""
    pat = cfg.recurrent.block_pattern
    g, rem = divmod(cfg.n_layers, len(pat))
    rem_pat = pat[:rem]
    n_rec = g * pat.count("rec") + rem_pat.count("rec")
    n_attn = g * pat.count("attn") + rem_pat.count("attn")
    return g, rem_pat, n_rec, n_attn


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The kind of each layer in order, "rec" or "attn"."""
    g, rem_pat, _, _ = layer_layout(cfg)
    return list(cfg.recurrent.block_pattern) * g + list(rem_pat)


def rec_mixer_defs(cfg: ModelConfig, n: int) -> dict:
    D = cfg.d_model
    R = cfg.recurrent.lru_width or D
    W = cfg.recurrent.d_conv
    nb = cfg.n_heads                      # block-diagonal gate blocks
    rb = R // nb
    return {
        "norm": ParamDef((n, D), ("layers", "embed"), init="zeros"),
        "w_x": ParamDef((n, D, R), ("layers", "embed", "mlp")),
        "w_gin": ParamDef((n, D, R), ("layers", "embed", "mlp")),
        "conv_w": ParamDef((n, W, R), ("layers", None, "mlp"), scale=0.5),
        "w_a": ParamDef((n, nb, rb, rb), ("layers", "heads", None, None)),
        "b_a": ParamDef((n, R), ("layers", "mlp"), init="zeros"),
        "w_i": ParamDef((n, nb, rb, rb), ("layers", "heads", None, None)),
        "b_i": ParamDef((n, R), ("layers", "mlp"), init="zeros"),
        "lam": ParamDef((n, R), ("layers", "mlp"), init="lru_lambda",
                        dtype="float32"),
        "w_out": ParamDef((n, R, D), ("layers", "mlp", "embed")),
    }


def param_defs(cfg: ModelConfig) -> dict:
    _, _, n_rec, n_attn = layer_layout(cfg)
    D, V = cfg.d_model, cfg.vocab
    defs = {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=0.02),
        "final_norm": ParamDef((D,), ("embed",), init="zeros"),
        "rec": {**rec_mixer_defs(cfg, n_rec), **dense.mlp_defs(cfg, n_rec)},
        "attn": {**dense.attn_defs(cfg, n_attn),
                 **dense.mlp_defs(cfg, n_attn)},
    }
    if not cfg.tie_embeddings:
        defs["out_head"] = ParamDef((D, V), ("embed", "vocab"))
    return defs


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _block_diag_mm(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """x (..., R) @ block-diag w (nb, rb, rb) + b."""
    nb, rb, _ = w.shape
    xs = x.reshape(x.shape[:-1] + (nb, rb))
    y = torch.einsum("...nr,nrs->...ns", xs, w)
    return y.reshape(x.shape) + b


class RecMixer(dense._Leaves):
    """One layer's recurrent temporal-mixing sublayer (pre-norm; the
    residual is the caller's)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(rec_mixer_defs(cfg, 1), dtype, device, stacked=True)
        self.cfg = cfg

    def _gates(self, xc: torch.Tensor):
        """-> (log_a, gated input), float32. xc (B, L/1, R)."""
        r = torch.sigmoid(_block_diag_mm(xc, self.w_a, self.b_a).float())
        i = torch.sigmoid(_block_diag_mm(xc, self.w_i, self.b_i).float())
        log_a = -_LRU_C * F.softplus(self.lam) * r
        beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                      min=1e-12))
        return log_a, beta * i * xc.float()

    def _inputs(self, x: torch.Tensor):
        h = common.rms_norm(x, self.norm, self.cfg.norm_eps)
        return h @ self.w_x, h @ self.w_gin

    def forward(self, x: torch.Tensor):
        """Full sequence from zero states. x (B, L, D). Returns (out,
        (conv state (B, W-1, R), last h (B, R) in x's type))."""
        xb, gate = self._inputs(x)
        xc, conv_out = causal_conv(xb, self.conv_w)
        log_a, b = self._gates(xc)
        hs = kops.lru_scan(torch.exp(log_a), b)
        y = hs.to(x.dtype) * F.gelu(gate, approximate="tanh")
        return y @ self.w_out, (conv_out, hs[:, -1].to(x.dtype))

    def step(self, x: torch.Tensor, conv_state: torch.Tensor,
             h_state: torch.Tensor):
        """One token. x (B, 1, D); conv_state (B, W-1, R); h_state
        (B, R). Returns (out, (new conv state, new h in x's type))."""
        xb, gate = self._inputs(x)
        xc1, conv_out = conv_step(xb[:, 0], self.conv_w, conv_state)
        log_a, b = self._gates(xc1)
        hf = h_state.float() * torch.exp(log_a) + b
        y = hf[:, None].to(x.dtype) * F.gelu(gate, approximate="tanh")
        return y @ self.w_out, (conv_out, hf.to(x.dtype))


class RecLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.mixer = RecMixer(cfg, dtype, device)
        self.mlp = dense.DenseMLP(cfg, dtype, device)


class AttnLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.attn = dense.DenseAttention(cfg, dtype, device)
        self.mlp = dense.DenseMLP(cfg, dtype, device)


class HybridLM(nn.Module):
    """embed (V, D), final_norm (D,), out_head (D, V) unless tied, and
    ``layers``: one :class:`RecLayer` or :class:`AttnLayer` per layer in
    the order of the pattern. Allocated empty; :func:`init` or
    ``convert.params_from_numpy`` fills it."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = common.torch_dtype(cfg.dtype)
        top = {k: d for k, d in param_defs(cfg).items()
               if not isinstance(d, dict)}
        self.top = dense._Leaves(top, dtype, device, stacked=False)
        kinds = layer_kinds(cfg)
        self.layers = nn.ModuleList(
            (RecLayer if kind == "rec" else AttnLayer)(cfg, dtype, device)
            for kind in kinds)
        # stack name -> the layers that hold its slices, in stack order
        self.stacks = {kind: [i for i, k in enumerate(kinds) if k == kind]
                       for kind in ("rec", "attn")}

    def leaf(self, name: str, layer: Optional[int] = None,
             stack: str = "rec") -> nn.Parameter:
        """The parameter of ParamDef ``name``; ``layer`` picks the slice
        of a leaf of ``stack`` ("rec" or "attn")."""
        if layer is None:
            return getattr(self.top, name)
        lm = self.layers[self.stacks[stack][layer]]
        first = lm.mixer if stack == "rec" else lm.attn
        return getattr(first if hasattr(first, name) else lm.mlp, name)


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, *, device=None) -> HybridLM:
    """Random parameters with the JAX package's initializers (``lam``
    float32 in any model type), drawn leaf by leaf from a
    ``torch.Generator`` on ``device`` seeded with ``seed``; the numbers
    differ from ``jax.random``'s."""
    dev = _device.resolve(device)
    return dense.init_leaves(HybridLM(cfg, device=dev), param_defs(cfg),
                             seed, dev)


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, model: HybridLM,
           tokens: torch.Tensor) -> torch.Tensor:
    x = dense.embed(cfg, model, tokens)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)


def _run_sequence(cfg: ModelConfig, model: HybridLM, x: torch.Tensor,
                  on_rec=None, on_attn=None) -> torch.Tensor:
    """The full-sequence pass; ``on_rec(conv, h)`` and ``on_attn(k, v)``
    receive each layer's states in order."""
    S = x.shape[1]
    win = cfg.recurrent.local_window
    positions = torch.arange(S, device=x.device)
    mask = common.causal_mask(S, S, window=win, device=x.device)
    for layer in model.layers:
        if isinstance(layer, RecLayer):
            o, (conv, h) = layer.mixer(x)
            if on_rec is not None:
                on_rec(conv, h)
        else:
            o, (k, v) = layer.attn(x, positions, mask, window=win)
            if on_attn is not None:
                on_attn(k, v)
        x = x + o
        x = x + layer.mlp(x)
    return x


def hidden(cfg: ModelConfig, model: HybridLM,
           tokens: torch.Tensor) -> torch.Tensor:
    """The last layer's output before the final norm, (B, S, D)."""
    return _run_sequence(cfg, model, _embed(cfg, model, tokens))


@torch.no_grad()
def forward(cfg: ModelConfig, model: HybridLM,
            tokens: torch.Tensor) -> torch.Tensor:
    """Scoring forward. tokens (B, S) -> logits (B, S, V)."""
    return dense.unembed(cfg, model, hidden(cfg, model, tokens))


def init_decode_cache(cfg: ModelConfig, batch: int, context_len: int, *,
                      device=None) -> dict:
    """Recurrent states and a ring KV cache of min(local_window,
    context_len) slots, in the model's type."""
    _, _, n_rec, n_attn = layer_layout(cfg)
    R = cfg.recurrent.lru_width or cfg.d_model
    W = cfg.recurrent.d_conv
    win = min(cfg.recurrent.local_window, context_len)
    dt = common.torch_dtype(cfg.dtype)
    dev = _device.resolve(device)
    cache = attention.init_cache(n_attn, batch, win, cfg.n_kv_heads,
                                 cfg.head_dim, dt, device=dev)
    cache["conv"] = torch.zeros((n_rec, batch, W - 1, R), dtype=dt,
                                device=dev)
    cache["h"] = torch.zeros((n_rec, batch, R), dtype=dt, device=dev)
    return cache


@torch.no_grad()
def prefill(cfg: ModelConfig, model: HybridLM, tokens: torch.Tensor,
            pad_to: int = 0) -> Tuple[torch.Tensor, dict]:
    """Run a prompt; keep each recurrent layer's conv and h state and
    re-pack the last min(S, local_window) keys of each attention layer
    into a ring cache of local_window slots (the slot of position p is
    p % window) so ``serve_step`` can continue. The cache has a fixed
    size, so ``pad_to`` is ignored (as in the JAX package)."""
    B, S = tokens.shape
    x = _embed(cfg, model, tokens)
    win = cfg.recurrent.local_window
    _, _, n_rec, n_attn = layer_layout(cfg)
    cache = attention.init_cache(n_attn, B, win, cfg.n_kv_heads,
                                 cfg.head_dim, x.dtype, device=x.device)
    keep = torch.arange(S - min(S, win), S, device=x.device)
    ring_slot = keep % win
    convs, hs, attn_layer = [], [], iter(range(n_attn))

    def on_rec(conv, h):
        convs.append(conv)
        hs.append(h)

    def on_attn(k, v):
        ai = next(attn_layer)
        cache["k"][ai][:, ring_slot] = k[:, keep]
        cache["v"][ai][:, ring_slot] = v[:, keep]

    x = _run_sequence(cfg, model, x, on_rec, on_attn)
    cache["kv_pos"][ring_slot] = keep.to(torch.int32)
    cache["conv"] = torch.stack(convs)
    cache["h"] = torch.stack(hs)
    cache["next_pos"] = S
    return dense.unembed(cfg, model, x[:, -1:]), cache


@torch.no_grad()
def serve_step(cfg: ModelConfig, model: HybridLM, cache: dict,
               tokens: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Decode ONE token. tokens (B, 1) -> (logits (B, 1, V), cache).

    The ring slot of this position gets its k/v; the window mask hides
    keys more than local_window - 1 positions back. The cache is updated
    in place and returned."""
    x = _embed(cfg, model, tokens)
    pos = cache["next_pos"]
    slot = pos % cache["k"].shape[2]
    cache["kv_pos"][slot] = pos
    mask = attention.decode_mask(pos, cache["kv_pos"],
                                 window=cfg.recurrent.local_window)
    ri = ai = 0
    for layer in model.layers:
        if isinstance(layer, RecLayer):
            o, (conv, h) = layer.mixer.step(x, cache["conv"][ri],
                                            cache["h"][ri])
            cache["conv"][ri] = conv
            cache["h"][ri] = h
            ri += 1
        else:
            o = layer.attn.decode(x, cache["k"][ai], cache["v"][ai], pos,
                                  slot, mask)
            ai += 1
        x = x + o
        x = x + layer.mlp(x)
    cache["next_pos"] = pos + 1
    return dense.unembed(cfg, model, x), cache

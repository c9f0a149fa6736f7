"""Dense decoder-only LM (command-r, stablelm, nemotron-4, mistral-large).

Counterpart of ``repro.models.dense``: a pre-norm GQA transformer with
RoPE and a gated or plain MLP. :class:`DenseLM` keeps one submodule per
layer (its attention and MLP leaves in two children) with the JAX
package's per-layer weight layouts (``wq`` (D, H, hd), ``wk``/``wv``
(D, KV, hd), ``wo`` (H, hd, D), ``w_up``/``w_gate`` (D, F), ``w_down``
(F, D)); the JAX package stacks them on a leading layer axis and scans.
The functions take the module where the JAX ones take the parameter
tree.

Not ported: the sharding ``constrain`` calls (they do nothing on one
card; the dry-run resolves their layouts in ``sharding.constraints``). The parameters are made without gradients and serving runs
under ``torch.no_grad``; ``trainer.init_train_state`` turns gradients
on. Training (:func:`loss_fn`) takes a route of its own through
:func:`hidden` (``train=True``): ``attend``'s plain path, as the JAX
package trains through its jnp ``attend`` (the flash kernel has no
backward), and each layer under ``cfg.remat`` (:func:`_maybe_remat`).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common
from repro_torch.models.common import ParamDef


# ---------------------------------------------------------------------------
# Parameter definitions (the JAX package's stacked shapes)
# ---------------------------------------------------------------------------

def attn_defs(cfg: ModelConfig, L: int) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "attn_norm": ParamDef((L, D), ("layers", "embed"), init="zeros"),
        "wq": ParamDef((L, D, H, hd), ("layers", "embed", "heads", "head_dim")),
        "wk": ParamDef((L, D, KV, hd), ("layers", "embed", "kv", "head_dim")),
        "wv": ParamDef((L, D, KV, hd), ("layers", "embed", "kv", "head_dim")),
        "wo": ParamDef((L, H, hd, D), ("layers", "heads", "head_dim", "embed")),
    }


def mlp_defs(cfg: ModelConfig, L: int) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    defs = {
        "mlp_norm": ParamDef((L, D), ("layers", "embed"), init="zeros"),
        "w_up": ParamDef((L, D, F), ("layers", "embed", "mlp")),
        "w_down": ParamDef((L, F, D), ("layers", "mlp", "embed")),
    }
    if cfg.gated_mlp:
        defs["w_gate"] = ParamDef((L, D, F), ("layers", "embed", "mlp"))
    return defs


def param_defs(cfg: ModelConfig) -> dict:
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    defs = {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=0.02),
        "final_norm": ParamDef((D,), ("embed",), init="zeros"),
        "layers": {**attn_defs(cfg, L), **mlp_defs(cfg, L)},
    }
    if not cfg.tie_embeddings:
        defs["out_head"] = ParamDef((D, V), ("embed", "vocab"))
    return defs


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class _Leaves(nn.Module):
    """Parameters named after ParamDefs, one layer's slice of each."""

    def __init__(self, defs: dict, dtype: torch.dtype, device, stacked: bool):
        super().__init__()
        for name, d in defs.items():
            shape = d.shape[1:] if stacked else d.shape
            dt = common.torch_dtype(d.dtype) if d.dtype else dtype
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dt, device=device),
                requires_grad=False))


class DenseAttention(_Leaves):
    """One layer's attention sublayer: attn_norm, wq, wk, wv, wo."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(attn_defs(cfg, 1), dtype, device, stacked=True)
        self.cfg = cfg

    def _qkv(self, x: torch.Tensor):
        cfg = self.cfg
        B, S, D = x.shape
        h = common.rms_norm(x, self.attn_norm, cfg.norm_eps)
        q = (h @ self.wq.reshape(D, -1)).reshape(B, S, cfg.n_heads, -1)
        k = (h @ self.wk.reshape(D, -1)).reshape(B, S, cfg.n_kv_heads, -1)
        v = (h @ self.wv.reshape(D, -1)).reshape(B, S, cfg.n_kv_heads, -1)
        return q, k, v

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        B, S = o.shape[:2]
        return o.reshape(B, S, -1) @ self.wo.reshape(-1, self.cfg.d_model)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                mask: torch.Tensor, window: Optional[int] = None, *,
                kernel: bool = True
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Full-sequence attention. x (B, S, D). Returns (out, (k, v));
        ``window`` defaults to ``cfg.window``. ``kernel=False`` leaves
        out ``attend``'s kernel hints, so attention takes its plain
        (differentiable) path on any device: the training route."""
        cfg = self.cfg
        window = cfg.window if window is None else window
        q, k, v = self._qkv(x)
        q = common.rope(q, positions, cfg.rope_theta)
        k = common.rope(k, positions, cfg.rope_theta)
        hints = {"causal": True, "window": window} if kernel else {}
        o = attention.attend(q, k, v, mask=mask, **hints)
        return self._out(o), (k, v)

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, pos: int, slot: int,
               mask: torch.Tensor) -> torch.Tensor:
        """One-token attention. x (B, 1, D); the layer caches (B, S, KV,
        hd) get this token's k/v at ``slot`` in place."""
        cfg = self.cfg
        q, k, v = self._qkv(x)
        posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = common.rope(q, posv, cfg.rope_theta)
        k = common.rope(k, posv, cfg.rope_theta)
        attention.update_layer_cache(k_cache, v_cache, k, v, slot)
        return self._out(attention.attend(q, k_cache, v_cache, mask=mask))


class DenseMLP(_Leaves):
    """One layer's MLP sublayer: mlp_norm, w_up, (w_gate), w_down."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(mlp_defs(cfg, 1), dtype, device, stacked=True)
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = common.rms_norm(x, self.mlp_norm, cfg.norm_eps)
        up = h @ self.w_up
        if cfg.gated_mlp:
            act = common.activate(h @ self.w_gate, cfg.activation) * up
        else:
            act = common.activate(up, cfg.activation)
        return act @ self.w_down


class DenseLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.attn = DenseAttention(cfg, dtype, device)
        self.mlp = DenseMLP(cfg, dtype, device)

    def forward(self, x, positions, mask, *, kernel: bool = True):
        a, kv = self.attn(x, positions, mask, kernel=kernel)
        x = x + a
        return x + self.mlp(x), kv


class DenseLM(nn.Module):
    """embed (V, D), final_norm (D,), out_head (D, V) unless tied, and
    ``layers``: one ``Layer`` (:class:`DenseLayer`; the moe family's
    subclass swaps it) per layer. Allocated empty; :func:`init` or
    ``convert.params_from_numpy`` fills it."""

    Layer = DenseLayer

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = common.torch_dtype(cfg.dtype)
        top = {k: d for k, d in param_defs(cfg).items() if k != "layers"}
        self.top = _Leaves(top, dtype, device, stacked=False)
        self.layers = nn.ModuleList(self.Layer(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))

    def leaf(self, name: str, layer: Optional[int] = None,
             stack: str = "layers") -> nn.Parameter:
        """The parameter of ParamDef ``name``; ``layer`` picks the slice
        of a stacked (per-layer) leaf (the one stack is ``layers``)."""
        if layer is None:
            return getattr(self.top, name)
        lm = self.layers[layer]
        return getattr(lm.attn if hasattr(lm.attn, name) else lm.mlp, name)


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, *, device=None) -> DenseLM:
    """Random parameters with the JAX package's initializers (normal
    with scale 1/sqrt(fan_in) of the stacked shape, zeros for the norm
    gains, 0.02 for the embedding), drawn leaf by leaf (one layer's
    slice at a time) by :func:`init_leaves` from ``seed``, the same
    bits on every device. The numbers differ from ``jax.random``'s."""
    dev = _device.resolve(device)
    return init_leaves(DenseLM(cfg, device=dev), param_defs(cfg), seed, dev)


@torch.no_grad()
def init_leaves(model: nn.Module, defs: dict, seed: int,
                device: torch.device) -> nn.Module:
    """Fill ``model`` from ``defs`` with the counter-based draws of
    ``common.init_``: leaves numbered in the order of ``defs``. A leaf
    of a dict whose first logical axis is ``"layers"`` is a stack, drawn
    one layer's slice at a time, each slice at its offset in the stacked
    leaf; any other leaf of a dict (vlm's ``projector``) is drawn whole.
    ``model.leaf(name, layer, group)`` names each parameter (``layer``
    None for an unstacked leaf of dict ``group``); ``device`` is where
    the model lies."""
    leaf = 0
    for name, d in defs.items():
        for lname, ld in (d.items() if isinstance(d, dict)
                          else [(None, d)]):
            if lname is None:
                common.init_(model.leaf(name), ld, seed, leaf)
            elif not is_stacked(ld):
                common.init_(model.leaf(lname, None, name), ld, seed, leaf)
            else:
                n = int(math.prod(ld.shape[1:]))
                for li in range(ld.shape[0]):
                    common.init_(model.leaf(lname, li, name), ld, seed,
                                 leaf, start=li * n)
            leaf += 1
    if device.type == "cuda":
        # hand the draws' float64 temporaries back to the device: left in
        # the allocator's cache, their blocks are split by what is
        # allocated next (a train state's moments, which live on) and
        # fragment the pool a training step then needs
        torch.cuda.empty_cache()
    return model


def is_stacked(d: ParamDef) -> bool:
    """Whether a definition is stacked on a leading layer axis."""
    return bool(d.axes) and d.axes[0] == "layers"


LM = DenseLM


# ---------------------------------------------------------------------------
# Public model API
# ---------------------------------------------------------------------------

def embed(cfg: ModelConfig, model: nn.Module,
          tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding rather than indexing: its CUDA backward sums each
    # row's gradient in a fixed order, where the index backward
    # accumulates with atomics (a train step must repeat bit for bit)
    return F.embedding(tokens.long(), model.top.embed).to(
        common.torch_dtype(cfg.dtype))


def unembed(cfg: ModelConfig, model: nn.Module,
            x: torch.Tensor) -> torch.Tensor:
    x = common.rms_norm(x, model.top.final_norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ model.top.embed.t()
    else:
        logits = x @ model.top.out_head
    return common.softcap(logits, cfg.logit_softcap)


def _layer_out(layer: DenseLayer, x, positions, mask, kernel=True):
    return layer(x, positions, mask, kernel=kernel)[0]


# the matrix products remat="dots" keeps (JAX's checkpoint_dots): every
# projection and attention einsum reaches autograd as one of these
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat``: "full" keeps only the layer's input
    for the backward and recomputes the rest, "dots" keeps the matrix
    products' outputs (selective checkpointing), "none" keeps all."""
    if cfg.remat == "full":
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            _ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _dots_policy))
    if cfg.remat == "none":
        return fn
    raise ValueError(f"unknown remat {cfg.remat!r}; one of none, full, dots")


def hidden(cfg: ModelConfig, model: DenseLM, tokens: torch.Tensor, *,
           train: bool = False) -> torch.Tensor:
    """The last layer's output before the final norm, (B, S, D).
    ``train=True`` is the differentiable route: attention's plain path
    (no kernel hints) and each layer under ``cfg.remat``."""
    return hidden_embedded(cfg, model, embed(cfg, model, tokens),
                           train=train)


def hidden_embedded(cfg: ModelConfig, model: DenseLM, x: torch.Tensor, *,
                    train: bool = False) -> torch.Tensor:
    """:func:`hidden` from the embedded sequence x (B, S, D) (vlm's
    visual prefix and text)."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    mask = common.causal_mask(S, S, window=cfg.window, device=x.device)
    body = _maybe_remat(cfg, functools.partial(_layer_out, kernel=False)) \
        if train else _layer_out
    for layer in model.layers:
        x = body(layer, x, positions, mask)
    return x


@torch.no_grad()
def forward(cfg: ModelConfig, model: DenseLM,
            tokens: torch.Tensor) -> torch.Tensor:
    """Scoring forward. tokens (B, S) -> logits (B, S, V)."""
    return unembed(cfg, model, hidden(cfg, model, tokens))


def loss_fn(cfg: ModelConfig, model: DenseLM, batch: dict) -> torch.Tensor:
    """Mean next-token CE of ``batch["tokens"]`` (B, S), float32 0-d,
    differentiable through the training route (:func:`hidden`)."""
    tokens = batch["tokens"]
    logits = unembed(cfg, model, hidden(cfg, model, tokens, train=True))
    return common.cross_entropy(logits[:, :-1], tokens[:, 1:])


@torch.no_grad()
def prefill(cfg: ModelConfig, model: DenseLM, tokens: torch.Tensor,
            pad_to: int = 0) -> Tuple[torch.Tensor, dict]:
    """Build a KV cache from a prompt. Returns (last-token logits, cache).

    ``pad_to`` reserves cache room for subsequent decode steps. Each
    layer's k/v go straight into the cache as they are computed."""
    return prefill_embedded(cfg, model, embed(cfg, model, tokens), pad_to)


@torch.no_grad()
def prefill_embedded(cfg: ModelConfig, model: DenseLM, x: torch.Tensor,
                     pad_to: int = 0) -> Tuple[torch.Tensor, dict]:
    """:func:`prefill` from the embedded prompt x (B, S, D), for every
    ``Layer`` whose output starts (x, (k, v))."""
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)
    mask = common.causal_mask(S, S, window=cfg.window, device=x.device)
    cache = attention.init_cache(cfg.n_layers, B, max(pad_to, S),
                                 cfg.n_kv_heads, cfg.head_dim, x.dtype,
                                 device=x.device)
    for li, layer in enumerate(model.layers):
        x, (k, v) = layer(x, positions, mask)[:2]
        cache["k"][li, :, :S] = k
        cache["v"][li, :, :S] = v
    cache["kv_pos"][:S] = torch.arange(S, dtype=torch.int32, device=x.device)
    cache["next_pos"] = S
    return unembed(cfg, model, x[:, -1:]), cache


def init_decode_cache(cfg: ModelConfig, batch: int, context_len: int, *,
                      device=None, abstract: bool = False) -> dict:
    """Cache for serve_step. Ring buffer of the window size when the arch
    has sliding-window attention; else full ``context_len``.
    ``abstract=True`` gives the dry-run's meta leaves
    (``attention.abstract_cache``).

    ``cfg.decode_window`` (the long-context variant) is applied by the
    launcher via ``cfg.replace(window=cfg.decode_window)``; this module
    honours ``cfg.window``."""
    w = min(cfg.window, context_len) if cfg.window > 0 else 0
    cache_len = w if w > 0 else context_len
    args = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim,
            common.torch_dtype(cfg.dtype))
    if abstract:
        return attention.abstract_cache(*args)
    return attention.init_cache(*args, device=_device.resolve(device))


@torch.no_grad()
def serve_step(cfg: ModelConfig, model: DenseLM, cache: dict,
               tokens: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Decode ONE token. tokens (B, 1) -> (logits (B, 1, V), cache).

    The cache is updated in place and returned."""
    x = embed(cfg, model, tokens)
    pos = cache["next_pos"]
    cache_len = cache["k"].shape[2]
    w = cfg.window   # 0 = full attention (see init_decode_cache docstring)
    # Ring buffer only when the cache was allocated at exactly the window
    # size (init_decode_cache); a prefill-padded full cache writes at pos.
    ring = w > 0 and cache_len == w
    slot = pos % cache_len if ring else pos
    if not 0 <= slot < cache_len:
        raise IndexError(f"decode position {pos} outside a cache of "
                         f"{cache_len} slots (the cache is full)")
    cache["kv_pos"][slot] = pos        # the current token attends to itself
    mask = attention.decode_mask(pos, cache["kv_pos"], window=w)
    for li, layer in enumerate(model.layers):
        x = x + layer.attn.decode(x, cache["k"][li], cache["v"][li], pos,
                                  slot, mask)
        x = x + layer.mlp(x)
    cache["next_pos"] = pos + 1
    return unembed(cfg, model, x), cache

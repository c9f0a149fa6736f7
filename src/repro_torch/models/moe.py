"""Mixture-of-Experts LM (qwen3-moe-30b-a3b, mixtral-8x22b).

Counterpart of ``repro.models.moe``: the dense family's attention
sublayer, with the MLP replaced by a top-k routed expert layer with
capacity-based token dropping. :class:`MoELM` is a ``DenseLM`` whose
layers hold an :class:`MoEMLP` (``mlp_norm``, ``w_router`` (D, E),
``w_up``/``w_gate`` (E, D, F), ``w_down`` (E, F, D)) in the dense MLP's
place, so the dense ``prefill`` and ``serve_step`` serve it as they
are; :func:`forward` and :func:`loss_fn` also sum the router's
load-balance loss.

Routing, exactly as in JAX: the router's f32 softmax, the top k by a
stable descending sort (on a tie the lowest expert index wins, as with
``jax.lax.top_k``; ``torch.topk`` promises no order), gates
renormalised over the k. Each batch row is one routing group: an
assignment's rank inside its expert counts the earlier (token, k)
assignments to that expert; those ranked at or past the capacity C
drop. Dispatch is a scatter: every kept assignment owns one row of the
(E, B·C, D) buffer, so the scatter is an exact copy (``index_copy_``, no
atomic add; the dropped ones share a spare row that nothing reads) and
a dropped one adds 0. The expert products are batched matrix products
over E. Nothing in the layer waits on the host (no boolean indexing,
no ``bincount``), so decode queues a step's layers without a sync. The
JAX package's ``moe_block_einsum`` (dense one-hot dispatch) is not
ported; the tests hold this module against it.

Training (``hidden(train=True)``, each layer under ``cfg.remat``) goes
through the same layer. Its backward repeats bit for bit on the card:
the gather of the expert outputs scatters its gradient back with
atomic adds, but every kept assignment owns its row and a dropped one
adds an exact 0; a token's k copies are an expand, whose gradient is a
sum in a fixed order. The remat recompute picks the forward's routes:
it recomputes the router from the same input with the same
operations, and the stable sort breaks ties the same way. The f
factor of the load-balance loss comes from integer counts, so the
loss reaches ``w_router`` only through the mean probabilities, as in
JAX.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, dense
from repro_torch.models.common import ParamDef


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    m = cfg.moe
    c = math.ceil(tokens_per_group * m.top_k / m.num_experts
                  * m.capacity_factor)
    return max(4 * math.ceil(c / 4), 4)   # pad to a multiple of 4


def moe_defs(cfg: ModelConfig, L: int) -> dict:
    D, m = cfg.d_model, cfg.moe
    E, F_ = m.num_experts, m.d_expert
    defs = {
        "mlp_norm": ParamDef((L, D), ("layers", "embed"), init="zeros"),
        "w_router": ParamDef((L, D, E), ("layers", "embed", None)),
        "w_up": ParamDef((L, E, D, F_), ("layers", "experts", "embed", "mlp")),
        "w_down": ParamDef((L, E, F_, D), ("layers", "experts", "mlp", "embed")),
    }
    if cfg.gated_mlp:
        defs["w_gate"] = ParamDef((L, E, D, F_),
                                  ("layers", "experts", "embed", "mlp"))
    return defs


def param_defs(cfg: ModelConfig) -> dict:
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    defs = {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=0.02),
        "final_norm": ParamDef((D,), ("embed",), init="zeros"),
        "layers": {**dense.attn_defs(cfg, L), **moe_defs(cfg, L)},
    }
    if not cfg.tie_embeddings:
        defs["out_head"] = ParamDef((D, V), ("embed", "vocab"))
    return defs


# ---------------------------------------------------------------------------
# Routed expert layer
# ---------------------------------------------------------------------------

def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, largest first, a tie
    going to the lowest index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _counts(flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Assignments per expert along the last axis of ``flat`` (int64;
    an integer scatter-add, where ``bincount`` would wait on the host)."""
    return torch.zeros((*flat.shape[:-1], n_experts), dtype=torch.int64,
                       device=flat.device).scatter_add_(
        -1, flat, torch.ones_like(flat))


def route(cfg: ModelConfig, mlp: nn.Module, h: torch.Tensor):
    """h (B, S, D) -> (gates (B, S, k) in h's type, idx (B, S, k) int64,
    the Switch load-balance loss (f32, 0-d))."""
    m = cfg.moe
    E = m.num_experts
    probs = torch.softmax((h @ mlp.w_router).float(), dim=-1)
    gates, idx = top_k(probs, m.top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    f = _counts(idx.reshape(-1), E).float() / max(idx.numel(), 1)
    aux = E * (f * probs.mean(dim=(0, 1))).sum()
    return gates.to(h.dtype), idx, aux


def dispatch(idx: torch.Tensor, n_experts: int, cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx (B, S, k) -> (pos, keep), each (B, S·k) in (token, k) order:
    an assignment's rank among its group's assignments to its expert
    (JAX's cumulative count of a one-hot), and whether that rank is
    inside the capacity ``cap``. The rank is taken from a stable sort
    by expert, which keeps (token, k) order within an expert: the
    sorted position less the expert's first position."""
    B = idx.shape[0]
    flat = idx.reshape(B, -1)
    order = torch.argsort(flat, dim=1, stable=True)
    counts = _counts(flat, n_experts)
    first = counts.cumsum(1) - counts
    rank = torch.arange(flat.shape[1], device=idx.device) \
        - first.gather(1, flat.gather(1, order))
    pos = torch.empty_like(flat).scatter_(1, order, rank)
    return pos, pos < cap


def _expert_ffn(cfg: ModelConfig, mlp: nn.Module,
                xin: torch.Tensor) -> torch.Tensor:
    """xin (E, N, D) -> (E, N, D), each expert's (optionally gated) MLP."""
    up = torch.bmm(xin, mlp.w_up)
    if cfg.gated_mlp:
        act = common.activate(torch.bmm(xin, mlp.w_gate),
                              cfg.activation) * up
    else:
        act = common.activate(up, cfg.activation)
    return torch.bmm(act, mlp.w_down)


def moe_block(cfg: ModelConfig, mlp: nn.Module, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter-dispatch MoE sublayer. x (B, S, D) -> (out, aux_loss).
    Each batch row is one routing group (tokens_per_group = S); the
    dispatch buffer holds group b's C slots of expert e at rows
    e·B·C + b·C .. + C, so the expert products run on all groups at
    once. A dropped assignment writes to a spare row past them (as
    JAX's scatter drops it) and reads an exact 0 (as JAX's gather
    fills 0), whatever the expert slots hold; no step waits on the
    host."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.num_experts, m.top_k
    C = capacity(cfg, S)
    n = E * B * C
    h = common.rms_norm(x, mlp.mlp_norm, cfg.norm_eps)
    gates, idx, aux = route(cfg, mlp, h)
    pos, keep = dispatch(idx, E, C)
    group = torch.arange(B, device=x.device)[:, None]
    rows = torch.where(keep, idx.reshape(B, -1) * (B * C) + group * C + pos,
                       n).reshape(-1)
    # each token's row once for each of its k assignments, in (token, k)
    # order: an expand, whose backward sums a token's k gradients in a
    # fixed order
    hk = h.reshape(B * S, 1, D).expand(B * S, k, D).reshape(B * S * k, D)
    xin = h.new_zeros(n + 1, D).index_copy_(0, rows, hk)
    yout = _expert_ffn(cfg, mlp, xin[:n].view(E, B * C, D)).view(n, D)
    gath = torch.where(keep.reshape(-1, 1),
                       yout.index_select(0, rows.clamp_max(n - 1)), 0)
    w = gates.reshape(B, S * k)
    out = (gath.view(B, S * k, D) * w[..., None]).view(B, S, k, D).sum(2)
    return out, aux


class MoEMLP(dense._Leaves):
    """One layer's routed expert sublayer: mlp_norm, w_router, w_up,
    (w_gate), w_down. Called as a module it returns the output alone
    (what ``dense.serve_step`` adds); :func:`moe_block` also returns the
    layer's load-balance loss."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(moe_defs(cfg, 1), dtype, device, stacked=True)
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe_block(self.cfg, self, x)[0]


class MoELayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.attn = dense.DenseAttention(cfg, dtype, device)
        self.mlp = MoEMLP(cfg, dtype, device)

    def forward(self, x, positions, mask, *, kernel: bool = True):
        """-> (x, (k, v), the layer's load-balance loss)."""
        a, kv = self.attn(x, positions, mask, kernel=kernel)
        x = x + a
        mo, aux = moe_block(self.cfg, self.mlp, x)
        return x + mo, kv, aux


class MoELM(dense.DenseLM):
    """A ``DenseLM`` of :class:`MoELayer` s (``leaf`` and the top leaves
    as there)."""

    Layer = MoELayer


LM = MoELM


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, *, device=None) -> MoELM:
    """Random parameters with the JAX package's initializers, drawn leaf
    by leaf by ``dense.init_leaves`` from ``seed``, the same bits on
    every device; the numbers differ from ``jax.random``'s."""
    dev = _device.resolve(device)
    return dense.init_leaves(MoELM(cfg, device=dev), param_defs(cfg),
                             seed, dev)


# ---------------------------------------------------------------------------
# Public model API
# ---------------------------------------------------------------------------

def _layer_out(layer: MoELayer, x, positions, mask, kernel=True):
    x, _, aux = layer(x, positions, mask, kernel=kernel)
    return x, aux


def hidden(cfg: ModelConfig, model: MoELM, tokens: torch.Tensor, *,
           train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the last layer's output before the final norm (B, S, D), the
    load-balance loss summed over the layers); ``train=True`` as in
    ``dense.hidden``."""
    S = tokens.shape[1]
    x = dense.embed(cfg, model, tokens)
    positions = torch.arange(S, device=x.device)
    mask = common.causal_mask(S, S, window=cfg.window, device=x.device)
    body = dense._maybe_remat(cfg, functools.partial(_layer_out,
                                                     kernel=False)) \
        if train else _layer_out
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in model.layers:
        x, la = body(layer, x, positions, mask)
        aux = aux + la
    return x, aux


@torch.no_grad()
def forward(cfg: ModelConfig, model: MoELM, tokens: torch.Tensor,
            return_aux: bool = False):
    """Scoring forward. tokens (B, S) -> logits (B, S, V) (and the
    summed load-balance loss with ``return_aux``)."""
    x, aux = hidden(cfg, model, tokens)
    logits = dense.unembed(cfg, model, x)
    return (logits, aux) if return_aux else logits


def loss_fn(cfg: ModelConfig, model: MoELM, batch: dict) -> torch.Tensor:
    """Mean next-token CE of ``batch["tokens"]`` plus
    ``router_aux_weight`` times the mean layer's load-balance loss,
    float32 0-d, differentiable through the training route."""
    tokens = batch["tokens"]
    x, aux = hidden(cfg, model, tokens, train=True)
    logits = dense.unembed(cfg, model, x)
    ce = common.cross_entropy(logits[:, :-1], tokens[:, 1:])
    return ce + cfg.moe.router_aux_weight * aux / cfg.n_layers


prefill = dense.prefill
init_decode_cache = dense.init_decode_cache
serve_step = dense.serve_step

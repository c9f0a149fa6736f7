"""Mamba-2 (SSD, state-space duality) LM, attention-free (counterpart of
``repro.models.ssm``).

The chunked SSD forward (arXiv:2405.21060 §6): inside a chunk the
quadratic dual form, which is the ``ssd_chunk`` kernel on the card
(``kernels.ops.ssd_chunk``; the JAX package computes the same ``y_diag``
term in jnp), and across chunks a linear recurrence over the chunk
states in plain PyTorch. Decode keeps a constant-size recurrent state in
the model's type, as the JAX package does.

:class:`MambaLM` keeps one :class:`MambaBlock` per layer with the JAX
package's per-layer layouts (``w_z``/``w_x`` (D, d_inner), ``w_B``/
``w_C`` (D, G·N), ``w_dt`` (D, H), ``conv_*`` (W, C), ``w_out``
(d_inner, D)); the JAX package stacks them on a leading layer axis and
scans. Training (:func:`loss_fn`) takes a route of its own through
:func:`hidden` (``train=True``): the intra-chunk term by the plain
``ssd_chunk_torch``, which autograd differentiates (the kernel has no
backward; the JAX package trains through its jnp ``y_diag``), and each
layer under ``cfg.remat``, as the JAX package remats each layer. Not
ported: the sharding specs of the cache.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd_chunk as _ssd_chunk
from repro_torch.models import common, dense
from repro_torch.models.common import ParamDef


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return d_inner, H, s.head_dim, s.n_groups, s.d_state


def block_defs(cfg: ModelConfig, L: int) -> dict:
    D = cfg.d_model
    d_inner, H, P, G, N = _dims(cfg)
    W = cfg.ssm.d_conv
    return {
        "norm": ParamDef((L, D), ("layers", "embed"), init="zeros"),
        "w_z": ParamDef((L, D, d_inner), ("layers", "embed", "mlp")),
        "w_x": ParamDef((L, D, d_inner), ("layers", "embed", "mlp")),
        "w_B": ParamDef((L, D, G * N), ("layers", "embed", None)),
        "w_C": ParamDef((L, D, G * N), ("layers", "embed", None)),
        "w_dt": ParamDef((L, D, H), ("layers", "embed", "heads")),
        "conv_x": ParamDef((L, W, d_inner), ("layers", None, "mlp"),
                           scale=0.5),
        "conv_B": ParamDef((L, W, G * N), ("layers", None, None), scale=0.5),
        "conv_C": ParamDef((L, W, G * N), ("layers", None, None), scale=0.5),
        "dt_bias": ParamDef((L, H), ("layers", "heads"), init="zeros"),
        "A_log": ParamDef((L, H), ("layers", "heads"), init="zeros"),
        "D": ParamDef((L, H), ("layers", "heads"), init="ones"),
        "gn": ParamDef((L, d_inner), ("layers", "mlp"), init="zeros"),
        "w_out": ParamDef((L, d_inner, D), ("layers", "mlp", "embed")),
    }


def param_defs(cfg: ModelConfig) -> dict:
    V, D = cfg.vocab, cfg.d_model
    defs = {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=0.02),
        "final_norm": ParamDef((D,), ("embed",), init="zeros"),
        "layers": block_defs(cfg, cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        defs["out_head"] = ParamDef((D, V), ("embed", "vocab"))
    return defs


# ---------------------------------------------------------------------------
# Causal depthwise conv as shifted sums
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, C), w (W, C). Returns (y (B, L, C), final (B, W-1, C))."""
    B, L, C = x.shape
    W = w.shape[0]
    if init_state is None:
        init_state = torch.zeros((B, W - 1, C), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([init_state.to(x.dtype), x], dim=1)
    y = torch.zeros_like(x)
    for i in range(W):
        y = y + xp[:, i:i + L] * w[i]
    return y, xp[:, L:]


def conv_step(x_t: torch.Tensor, w: torch.Tensor, state: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token conv. x_t (B, C); state (B, W-1, C)."""
    xp = torch.cat([state.to(x_t.dtype), x_t[:, None]], dim=1)  # (B, W, C)
    y = torch.einsum("bwc,wc->bc", xp, w)
    return y, xp[:, 1:]


# ---------------------------------------------------------------------------
# SSD scan (chunked dual form)
# ---------------------------------------------------------------------------

def segsum(loga: torch.Tensor) -> torch.Tensor:
    """loga (..., q) -> (..., q, q): T[i, j] = sum_{j<k<=i}, -inf for j>i."""
    q = loga.shape[-1]
    z = torch.cumsum(loga, dim=-1)
    T = z[..., :, None] - z[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=loga.device).tril()
    return torch.where(mask, T, float("-inf"))


def _heads(m: torch.Tensor, H: int) -> torch.Tensor:
    """Groups (..., G, N) broadcast to heads (..., H, N), head h reading
    group h // (H/G) as ``jnp.repeat`` does; a view when G = 1."""
    G = m.shape[-2]
    if G == 1:
        return m.expand(*m.shape[:-2], H, m.shape[-1])
    return m.repeat_interleave(H // G, dim=-2)


def ssd_scan(xdt: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None, *,
             train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. xdt (B,L,H,P) = dt*x; loga (B,L,H); Bm/Cm (B,L,G,N).

    Recurrence per head: h_t = exp(loga_t) h_{t-1} + xdt_t ⊗ B_t,
    y_t = C_t · h_t. Returns (y (B,L,H,P), final_state (B,H,P,N)).

    The intra-chunk term is ``ops.ssd_chunk`` on the (B·c, q, H, ·)
    view of the chunks, so its Q is ``chunk``; its operands are float32
    (the JAX einsum casts x to float32 there), Bm/Cm broadcast to heads
    without a copy when G = 1. ``train=True`` takes the plain
    ``ssd_chunk_torch`` on any device instead (the training route)."""
    Bsz, L, H, P = xdt.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if L % chunk:
        raise ValueError(f"ssd_scan: L={L} is not a multiple of the chunk "
                         f"{chunk}")
    c, q = L // chunk, chunk
    rep = H // G

    xf = xdt.float()
    lc = loga.reshape(Bsz, c, q, H).float()
    Bf, Cf = Bm.float(), Cm.float()
    # ---- intra-chunk (quadratic dual form): the kernel ----
    chunk_fn = _ssd_chunk.ssd_chunk_torch if train else kops.ssd_chunk
    y_diag = chunk_fn(
        xf.reshape(Bsz * c, q, H, P), lc.reshape(Bsz * c, q, H),
        _heads(Bf.reshape(Bsz * c, q, G, N), H),
        _heads(Cf.reshape(Bsz * c, q, G, N), H)).reshape(Bsz, c, q, H, P)
    # ---- chunk states ----
    zc = torch.cumsum(lc, dim=2)                       # (B,c,q,H)
    decay = torch.exp(zc[:, :, -1:, :] - zc)           # (B,c,q,H)
    xg = (xf.reshape(Bsz, c, q, H, P) * decay[..., None]) \
        .reshape(Bsz, c, q, G, rep, P)
    Bg = Bf.reshape(Bsz, c, q, G, N)
    states = torch.einsum("bcqgn,bcqgrp->bcgrpn", Bg, xg) \
        .reshape(Bsz, c, H, P, N)
    # ---- inter-chunk recurrence ----
    chunk_decay = torch.exp(zc[:, :, -1, :])           # (B,c,H)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xdt.device) \
        if init_state is None else init_state.float()
    prev = []
    for ci in range(c):
        prev.append(h)
        h = h * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1).reshape(Bsz, c, G, rep, P, N)
    # ---- off-diagonal (carry-in) contribution ----
    Cg = Cf.reshape(Bsz, c, q, G, N)
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", Cg, prev_states) \
        .reshape(Bsz, c, q, H, P) * torch.exp(zc)[..., None]
    y = (y_diag + y_off).reshape(Bsz, L, H, P).to(xdt.dtype)
    return y, h.to(xdt.dtype)


def ssd_step(state: torch.Tensor, x_t: torch.Tensor, dt: torch.Tensor,
             A_log: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. state (B,H,P,N); x_t (B,H,P); dt (B,H);
    B_t/C_t (B,G,N). Returns (y (B,H,P), new state in state's type)."""
    H = x_t.shape[1]
    Bh, Ch = _heads(B_t, H).float(), _heads(C_t, H).float()
    a = torch.exp(-torch.exp(A_log.float()) * dt.float())
    xdt = x_t * dt[..., None].to(x_t.dtype)
    sf = state.float() * a[..., None, None] \
        + xdt.float()[..., :, None] * Bh[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", sf, Ch)
    return y.to(x_t.dtype), sf.to(state.dtype)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class MambaBlock(dense._Leaves):
    """One layer's Mamba-2 mixer (pre-norm; the residual is the
    caller's)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(block_defs(cfg, 1), dtype, device, stacked=True)
        self.cfg = cfg

    def _proj(self, h: torch.Tensor):
        """h (B,L,D) -> z, xh, B, C, dt (before the conv and softplus)."""
        return (h @ self.w_z, h @ self.w_x, h @ self.w_B, h @ self.w_C,
                h @ self.w_dt)

    def _gated_out(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        g = common.rms_norm(y * F.silu(z), self.gn, self.cfg.norm_eps)
        return g @ self.w_out

    def forward(self, x: torch.Tensor, *, train: bool = False):
        """Full-sequence mixer from zero states. x (B, L, D). Returns
        (out, (conv states {"x", "B", "C"}, final SSM state));
        ``train=True`` is :func:`ssd_scan`'s training route."""
        cfg = self.cfg
        d_inner, H, P, G, N = _dims(cfg)
        h = common.rms_norm(x, self.norm, cfg.norm_eps)
        z, xh, Bm, Cm, dt = self._proj(h)
        xh, cs_x = causal_conv(xh, self.conv_x)
        Bm, cs_B = causal_conv(Bm, self.conv_B)
        Cm, cs_C = causal_conv(Cm, self.conv_C)
        xh, Bm, Cm = F.silu(xh), F.silu(Bm), F.silu(Cm)
        dt = F.softplus(dt.float() + self.dt_bias)
        loga = -torch.exp(self.A_log.float()) * dt              # (B,L,H)

        Bsz, L, _ = x.shape
        xheads = xh.reshape(Bsz, L, H, P)
        xdt = xheads * dt[..., None].to(xheads.dtype)
        Bmr, Cmr = Bm.reshape(Bsz, L, G, N), Cm.reshape(Bsz, L, G, N)
        pad = (-L) % cfg.ssm.chunk
        if pad:
            # zero inputs and zero log-decay leave the carried state as
            # it is
            xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
            loga = F.pad(loga, (0, 0, 0, pad))
            Bmr = F.pad(Bmr, (0, 0, 0, 0, 0, pad))
            Cmr = F.pad(Cmr, (0, 0, 0, 0, 0, pad))
        y, final = ssd_scan(xdt, loga, Bmr, Cmr, cfg.ssm.chunk, train=train)
        y = y[:, :L] + xheads * self.D[None, None, :, None].to(xheads.dtype)
        out = self._gated_out(y.reshape(Bsz, L, d_inner), z)
        return out, ({"x": cs_x, "B": cs_B, "C": cs_C}, final)

    def decode(self, x: torch.Tensor, conv_state: dict,
               ssm_state: torch.Tensor):
        """One-token mixer. x (B, 1, D); conv_state {"x", "B", "C"} of
        (B, W-1, C); ssm_state (B, H, P, N). Returns (out, (new conv
        states, new SSM state))."""
        cfg = self.cfg
        d_inner, H, P, G, N = _dims(cfg)
        h = common.rms_norm(x, self.norm, cfg.norm_eps)
        z, xh, Bm, Cm, dt = self._proj(h)
        xh1, cs_x = conv_step(xh[:, 0], self.conv_x, conv_state["x"])
        Bm1, cs_B = conv_step(Bm[:, 0], self.conv_B, conv_state["B"])
        Cm1, cs_C = conv_step(Cm[:, 0], self.conv_C, conv_state["C"])
        xh1, Bm1, Cm1 = F.silu(xh1), F.silu(Bm1), F.silu(Cm1)
        dt1 = F.softplus(dt[:, 0].float() + self.dt_bias)
        Bsz = x.shape[0]
        y, new_state = ssd_step(ssm_state, xh1.reshape(Bsz, H, P), dt1,
                                self.A_log, Bm1.reshape(Bsz, G, N),
                                Cm1.reshape(Bsz, G, N))
        y = y + xh1.reshape(Bsz, H, P) * self.D[None, :, None].to(x.dtype)
        out = self._gated_out(y.reshape(Bsz, 1, d_inner), z)
        return out, ({"x": cs_x, "B": cs_B, "C": cs_C}, new_state)


class MambaLM(nn.Module):
    """embed (V, D), final_norm (D,), out_head (D, V) unless tied, and
    ``layers``: one :class:`MambaBlock` per layer. Allocated empty;
    :func:`init` or ``convert.params_from_numpy`` fills it."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = common.torch_dtype(cfg.dtype)
        top = {k: d for k, d in param_defs(cfg).items() if k != "layers"}
        self.top = dense._Leaves(top, dtype, device, stacked=False)
        self.layers = nn.ModuleList(MambaBlock(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))

    def leaf(self, name: str, layer: Optional[int] = None,
             stack: str = "layers") -> nn.Parameter:
        """The parameter of ParamDef ``name``; ``layer`` picks the slice
        of a stacked (per-layer) leaf."""
        if layer is None:
            return getattr(self.top, name)
        return getattr(self.layers[layer], name)


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, *, device=None) -> MambaLM:
    """Random parameters with the JAX package's initializers, drawn leaf
    by leaf (one layer's slice at a time) by ``dense.init_leaves`` from
    ``seed``, the same bits on every device; the numbers differ from
    ``jax.random``'s."""
    dev = _device.resolve(device)
    return dense.init_leaves(MambaLM(cfg, device=dev), param_defs(cfg),
                             seed, dev)


# ---------------------------------------------------------------------------
# Public model API
# ---------------------------------------------------------------------------

def _residual(block: MambaBlock, x: torch.Tensor,
              train: bool = False) -> torch.Tensor:
    return x + block(x, train=train)[0]


def hidden(cfg: ModelConfig, model: MambaLM, tokens: torch.Tensor, *,
           train: bool = False) -> torch.Tensor:
    """The last layer's output before the final norm, (B, S, D).
    ``train=True`` is the differentiable route: the plain intra-chunk
    term and each layer under ``cfg.remat``."""
    x = dense.embed(cfg, model, tokens)
    body = dense._maybe_remat(cfg, functools.partial(_residual, train=True)) \
        if train else _residual
    for block in model.layers:
        x = body(block, x)
    return x


@torch.no_grad()
def forward(cfg: ModelConfig, model: MambaLM,
            tokens: torch.Tensor) -> torch.Tensor:
    """Scoring forward. tokens (B, S) -> logits (B, S, V)."""
    return dense.unembed(cfg, model, hidden(cfg, model, tokens))


def loss_fn(cfg: ModelConfig, model: MambaLM, batch: dict) -> torch.Tensor:
    """Mean next-token CE of ``batch["tokens"]`` (B, S), float32 0-d,
    differentiable through the training route (:func:`hidden`)."""
    tokens = batch["tokens"]
    logits = dense.unembed(cfg, model, hidden(cfg, model, tokens, train=True))
    return common.cross_entropy(logits[:, :-1], tokens[:, 1:])


def init_decode_cache(cfg: ModelConfig, batch: int, context_len: int, *,
                      device=None) -> dict:
    """The constant-size recurrent state, independent of
    ``context_len``, in the model's type."""
    d_inner, H, P, G, N = _dims(cfg)
    W, L = cfg.ssm.d_conv, cfg.n_layers
    dt = common.torch_dtype(cfg.dtype)
    dev = _device.resolve(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    return {"conv": {"x": zeros(L, batch, W - 1, d_inner),
                     "B": zeros(L, batch, W - 1, G * N),
                     "C": zeros(L, batch, W - 1, G * N)},
            "state": zeros(L, batch, H, P, N),
            "next_pos": 0}


@torch.no_grad()
def prefill(cfg: ModelConfig, model: MambaLM, tokens: torch.Tensor,
            pad_to: int = 0) -> Tuple[torch.Tensor, dict]:
    """Run a prompt and keep each layer's conv and SSM state. Returns
    (last-token logits, cache). The state has a constant size, so
    ``pad_to`` is ignored (as in the JAX package)."""
    S = tokens.shape[1]
    x = dense.embed(cfg, model, tokens)
    convs, states = {"x": [], "B": [], "C": []}, []
    for block in model.layers:
        o, (cs, final) = block(x)
        x = x + o
        for k in convs:
            convs[k].append(cs[k])
        states.append(final)
    cache = {"conv": {k: torch.stack(v) for k, v in convs.items()},
             "state": torch.stack(states), "next_pos": S}
    return dense.unembed(cfg, model, x[:, -1:]), cache


@torch.no_grad()
def serve_step(cfg: ModelConfig, model: MambaLM, cache: dict,
               tokens: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Decode ONE token. tokens (B, 1) -> (logits (B, 1, V), cache).

    The cache is updated in place and returned."""
    x = dense.embed(cfg, model, tokens)
    conv = cache["conv"]
    for li, block in enumerate(model.layers):
        o, (cs, st) = block.decode(x, {k: v[li] for k, v in conv.items()},
                                   cache["state"][li])
        x = x + o
        for k in conv:
            conv[k][li] = cs[k]
        cache["state"][li] = st
    cache["next_pos"] += 1
    return dense.unembed(cfg, model, x), cache

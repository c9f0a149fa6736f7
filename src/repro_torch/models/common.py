"""Shared model machinery: parameter definitions, init, layer math.

The port's counterpart of ``repro.models.common``. Each model module
defines its parameters once as a tree of :class:`ParamDef` (shape,
logical axes, initializer) with the JAX package's shapes, stacked
layers included; the port keeps each layer's leaves in a submodule of
its own, and :func:`init_` draws them one leaf (one layer's slice) at a
time from an explicit ``torch.Generator`` on the target device, so no
whole tree is ever built in float32. The abstract (dry-run) trees and
logical sharding specs are not ported (ROADMAP, dry-run item).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tree = Any

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name as a torch dtype."""
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; one of {list(DTYPES)}")
    return DTYPES[name]


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | lru_lambda
    scale: Optional[float] = None   # None -> 1/sqrt(fan_in) for "normal"
    dtype: Optional[str] = None     # None -> model dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _fan_in(shape: Tuple[int, ...]) -> int:
    # The JAX package's convention: every axis but the last is fan-in,
    # the stacked layer axis included.
    if len(shape) <= 1:
        return max(shape[0] if shape else 1, 1)
    return int(np.prod(shape[:-1]))


def _leaves(defs: Tree):
    if isinstance(defs, ParamDef):
        yield defs
    else:
        for v in defs.values():
            yield from _leaves(v)


def count_params(defs: Tree) -> int:
    return int(sum(np.prod(d.shape) for d in _leaves(defs)))


@torch.no_grad()
def init_(t: torch.Tensor, d: ParamDef, gen: torch.Generator) -> None:
    """Fill ``t`` in place from definition ``d``. ``t`` is the whole
    leaf or one layer's slice of a stacked leaf; the scale is taken
    from ``d.shape``, so a slice is drawn like its part of the stacked
    leaf. The draw is float32 of ``t``'s size, then cast."""
    if d.init == "zeros":
        t.zero_()
    elif d.init == "ones":
        t.fill_(1.0)
    elif d.init == "lru_lambda":
        u = torch.rand(t.shape, generator=gen, device=t.device)
        u = 0.9 + u * (0.999 - 0.9)
        t.copy_(torch.log(torch.expm1(-torch.log(u))))
    elif d.init == "normal":
        scale = d.scale if d.scale is not None \
            else 1.0 / math.sqrt(_fan_in(d.shape))
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device) * scale)
    else:
        raise ValueError(f"unknown init {d.init!r}")


# ---------------------------------------------------------------------------
# Common layer math
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma.float())).to(x.dtype)


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":                 # jax.nn.gelu's default: tanh form
        return F.gelu(x, approximate="tanh")
    if kind == "sq_relu":              # Nemotron-4 squared ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x (..., seq, heads, head_dim); positions (..., seq)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs   # (..., seq, half)
    cos = torch.cos(ang)[..., :, None, :]            # (..., seq, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_mask(sq: int, skv: int, *, q_offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """(sq, skv) boolean mask; True = attend. Query i sits at absolute
    position ``q_offset + i``; keys at 0..skv-1."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in float32. logits (..., V); labels int; ``mask``
    (labels' shape) weights each position, the mean taken over its sum."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()

"""GQA attention: the flash kernel for prefill, a query-chunked plain
path, and KV-cache utilities (counterpart of ``repro.models.attention``).

On a CUDA tensor with more than one query and the causal hint,
:func:`attend` always runs the hand-written flash kernel through
``kernels.ops.flash_attention`` (a meta tensor, the dry-run's, takes
the same route to the kernel's meta output); there is no switch (the
JAX package selects its Pallas kernel with ``REPRO_ATTN_IMPL=pallas``).
Everything else (CPU tensors, decode with one query, calls without the
hint) takes the plain path, which scans over query chunks so peak
memory is O(q_chunk * Skv).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import common

_NEG_INF = -1e30


def _scores_softmax_pv(q, k, v, mask, softcap_val):
    """q (B, Sq, KV, G, hd); k/v (B, Skv, KV, hd); mask (Sq, Skv) or
    (B, Sq, Skv). Scores in float32 (bf16 products are exact there, as
    with JAX's ``preferred_element_type=float32``), probabilities cast to
    v's type for the PV product."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    logits = common.softcap(logits, softcap_val)
    m = mask[:, None, None] if mask.dim() == 3 else mask[None, None, None]
    logits = torch.where(m, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)


def attend(
    q: torch.Tensor,              # (B, Sq, H, hd)
    k: torch.Tensor,              # (B, Skv, KV, hd)
    v: torch.Tensor,              # (B, Skv, KV, hd)
    *,
    mask: torch.Tensor,           # (Sq, Skv) or (B, Sq, Skv) bool
    softcap_val: float = 0.0,
    q_chunk: int = 1024,
    causal: Optional[bool] = None,   # semantic hints enabling the kernel
    window: int = 0,                 # path (mask stays the oracle)
) -> torch.Tensor:
    """Grouped-query attention. Returns (B, Sq, H, hd).

    With CUDA (or meta) tensors, Sq > 1 and the hints
    (``causal``/``window`` describing ``mask``) this is the flash kernel
    (its meta output on meta tensors). Otherwise the plain
    path runs over query chunks of ``q_chunk`` rows; unlike the JAX
    scan, the last chunk may be shorter, so a length that is not a
    multiple of ``q_chunk`` is chunked too (each row's softmax is its
    own, so chunking changes no value)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if (q.device.type in ("cuda", "meta") and Sq > 1
            and causal is not None and not kops._FORCE_PLAIN):
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    softcap=softcap_val)
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    outs = []
    for c0 in range(0, Sq, q_chunk):
        mc = mask[..., c0:c0 + q_chunk, :]
        outs.append(_scores_softmax_pv(qg[:, c0:c0 + q_chunk], k, v, mc,
                                       softcap_val))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, hd)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------
# A cache is a dict:
#   k, v     : (L, B, S_cache, KV, hd)
#   kv_pos   : (S_cache,) int32 — absolute position held by each slot,
#              -1 if empty. Shared across layers/batch (all sequences in a
#              batch advance in lockstep).
#   next_pos : int — absolute position of the NEXT token to write (a host
#              integer here; a 0-d int32 array in the JAX package).
# For a full cache S_cache == max_len and slot i holds position i.
# For a ring (sliding-window) cache S_cache == window and slot
# (pos % window) holds position pos. Decode updates the cache in place.


def init_cache(n_layers: int, batch: int, cache_len: int, n_kv: int,
               head_dim: int, dtype: torch.dtype, device=None) -> dict:
    shape = (n_layers, batch, cache_len, n_kv, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "kv_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                             device=device),
        "next_pos": 0,
    }


def abstract_cache(n_layers: int, batch: int, cache_len: int, n_kv: int,
                   head_dim: int, dtype: torch.dtype) -> dict:
    """:func:`init_cache`'s leaves as meta tensors (the dry-run's
    stand-in, no storage), ``next_pos`` a 0-d int32 as in the JAX
    package."""
    return abstract_pos(init_cache(n_layers, batch, cache_len, n_kv,
                                   head_dim, dtype, device="meta"))


def abstract_pos(cache: dict) -> dict:
    """``cache`` (on the meta device) with its host ``next_pos`` made a
    0-d int32 meta tensor, the JAX package's leaf; returns it."""
    cache["next_pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return cache


def cache_logical_specs() -> dict:
    """Logical axes of the cache leaves (see ``sharding/plans.py``)."""
    return {
        "k": ("layers", "cache_batch", "cache_seq", "kv", "head_dim"),
        "v": ("layers", "cache_batch", "cache_seq", "kv", "head_dim"),
        "kv_pos": (None,),
        "next_pos": (),
    }


def decode_mask(q_pos: int, kv_pos: torch.Tensor,
                window: int = 0) -> torch.Tensor:
    """Mask for one-token decode. q_pos int, kv_pos (S,). Returns (1, S)."""
    m = (kv_pos >= 0) & (kv_pos <= q_pos)
    if window > 0:
        m &= kv_pos > q_pos - window
    return m[None, :]


def update_layer_cache(k_l: torch.Tensor, v_l: torch.Tensor,
                       new_k: torch.Tensor, new_v: torch.Tensor, slot: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one token's (B, 1, KV, hd) into the layer cache (B, S, KV,
    hd) at ``slot``, in place (the JAX version returns updated copies);
    returns the same two tensors."""
    if not 0 <= slot < k_l.shape[1]:
        raise IndexError(f"cache slot {slot} outside a cache of "
                         f"{k_l.shape[1]} slots (the cache is full)")
    k_l[:, slot:slot + 1] = new_k.to(k_l.dtype)
    v_l[:, slot:slot + 1] = new_v.to(v_l.dtype)
    return k_l, v_l

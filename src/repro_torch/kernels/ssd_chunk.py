"""Mamba-2 intra-chunk SSD: the plain PyTorch version and the CUDA
kernel (counterpart of the JAX package's ``kernels/ssd_chunk.py``).

xdt (B, L, H, P), loga (B, L, H), Bm/Cm (B, L, H, N) (groups already
broadcast to heads) -> y (B, L, H, P) in xdt's type. The sequence is cut
into chunks of Q = min(256, L) positions; inside each chunk, with zero
initial state,

    y = (C Bᵀ ∘ Λ) x,   Λ[i, j] = exp(z_i - z_j)·[j <= i],
    z = cumsum(loga) inside the chunk,

in float32 throughout, rounded to xdt's type once. The JAX wrapper
requires L to be a multiple of Q; here a shorter last chunk is allowed
and the CUDA kernel masks it itself.

:func:`ssd_chunk_torch` computes what ``kernels/ref.py::ssd_chunk_ref``
computes, chunk by chunk. The CUDA kernel ``csrc/ssd_chunk.cu`` reads
its inputs through strides, so Bm/Cm broadcast from one group with
``expand`` (stride 0 on the head axis) are never copied;
:func:`ssd_chunk_cuda` launches it. On meta tensors
:func:`ssd_chunk_meta` gives its output shape and type and counts its
:func:`flops`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

CHUNK = 256          # the Pallas kernel's Q = min(256, L)
_MAX_DIM = 256       # P and N the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flops(B: int, L: int, H: int, P: int, N: int) -> int:
    """The operations of one call (one pass; ``chip_smoke.ssd_bound_ms``
    calls it): per (b, h) and query i of a chunk, i + 1 keys, each a
    score of N multiply-adds and a weighted sum of P."""
    Q = min(CHUNK, L)
    pairs = sum(q * (q + 1) // 2 for q in
                [Q] * (L // Q) + ([L % Q] if L % Q else []))
    return 2 * (N + P) * pairs * B * H


def ssd_chunk_meta(xdt: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor) -> torch.Tensor:
    """The kernel's output on the meta device: shape and type only, no
    arithmetic and no launch; adds the call's :func:`flops` to
    ``build.META_FLOPS``."""
    B, L, H, P = xdt.shape
    build.META_FLOPS["ssd_chunk"] += flops(B, L, H, P, Bm.shape[-1])
    return torch.empty_like(xdt)


def _chunks_torch(x, loga, Bm, Cm):
    """One chunk per leading index: (B', q, H, ·) float32 -> float32."""
    q = loga.shape[1]
    z = torch.cumsum(loga, dim=1)                         # (B', q, H)
    T = z[:, :, None, :] - z[:, None, :, :]               # (B', q, q, H)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    # mask before the exp: above the diagonal T is a sum of -loga >= 0,
    # whose exp may overflow, and an inf there would make the masked
    # entries' gradient nan (0 * inf) on the training route
    decay = torch.exp(torch.where(causal[None, :, :, None], T, -torch.inf))
    scores = torch.einsum("bqhn,bshn->bqsh", Cm, Bm)
    return torch.einsum("bqsh,bshp->bqhp", scores * decay, x)


def ssd_chunk_torch(xdt: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (the kernel's reference, and what the port
    runs for CPU tensors)."""
    B, L, H, P = xdt.shape
    Q = min(CHUNK, L)
    x, lg, bm, cm = (t.float() for t in (xdt, loga, Bm, Cm))
    n_full = L // Q
    parts = []
    if n_full:
        m = n_full * Q
        y = _chunks_torch(
            x[:, :m].reshape(B * n_full, Q, H, P),
            lg[:, :m].reshape(B * n_full, Q, H),
            bm[:, :m].reshape(B * n_full, Q, H, -1),
            cm[:, :m].reshape(B * n_full, Q, H, -1))
        parts.append(y.reshape(B, m, H, P))
    if L % Q:
        m = n_full * Q
        parts.append(_chunks_torch(x[:, m:], lg[:, m:], bm[:, m:],
                                   cm[:, m:]))
    y = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return y.to(xdt.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_chunk")
    fn = lib.ssd_chunk_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def ssd_chunk_cuda(xdt: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/ssd_chunk.cu``) on the current
    stream; same contract as :func:`ssd_chunk_torch`. The inputs may be
    strided views (the last axis of xdt, Bm and Cm contiguous). Raises
    on inputs the kernel does not take and on a failed launch; it never
    falls back to the plain version."""
    if xdt.dim() != 4 or loga.dim() != 3:
        raise ValueError(f"ssd_chunk_cuda: xdt must be 4-d and loga 3-d, "
                         f"got {tuple(xdt.shape)} and {tuple(loga.shape)}")
    B, L, H, P = xdt.shape
    N = Bm.shape[-1]
    for name, t in (("xdt", xdt), ("loga", loga), ("Bm", Bm), ("Cm", Cm)):
        if t.device.type != "cuda" or t.device != xdt.device:
            raise ValueError(f"ssd_chunk_cuda needs CUDA tensors on one "
                             f"device; {name} is on {t.device}")
        if t.dtype not in _DTYPES or t.dtype != xdt.dtype:
            raise ValueError(f"ssd_chunk_cuda: {name} must be float32 or "
                             f"bfloat16 like xdt ({xdt.dtype}), got "
                             f"{t.dtype}")
    if tuple(loga.shape) != (B, L, H) or Bm.shape != Cm.shape \
            or tuple(Bm.shape) != (B, L, H, N):
        raise ValueError(f"ssd_chunk_cuda: loga must be {(B, L, H)} and "
                         f"Bm/Cm {(B, L, H, N)}, got {tuple(loga.shape)}, "
                         f"{tuple(Bm.shape)} and {tuple(Cm.shape)}")
    if not (1 <= P <= _MAX_DIM and 1 <= N <= _MAX_DIM):
        raise ValueError(f"ssd_chunk_cuda: P={P} and N={N} must lie in "
                         f"[1, {_MAX_DIM}]")
    for name, t in (("xdt", xdt), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"ssd_chunk_cuda: the last axis of {name} must "
                             f"be contiguous")
    y = torch.empty((B, L, H, P), dtype=xdt.dtype, device=xdt.device)
    if B == 0 or L == 0 or H == 0:
        return y
    strides = (ctypes.c_longlong * 12)(
        *xdt.stride()[:3], *loga.stride(), *Bm.stride()[:3],
        *Cm.stride()[:3])
    lib = _lib()
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device)
        err = lib.ssd_chunk_launch(
            xdt.data_ptr(), loga.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), _DTYPES[xdt.dtype], B, L, H, P, N, min(CHUNK, L),
            ctypes.addressof(strides), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed with CUDA error "
                           f"{err}")
    build.LAUNCHES["ssd_chunk"] += 1
    return y

"""Forward GQA flash attention: the plain PyTorch version and the CUDA
kernel (counterpart of the JAX package's ``kernels/flash_attention.py``).

q (B, Sq, H, hd); k/v (B, Skv, KV, hd) -> (B, Sq, H, hd) in q's type.
The G = H/KV query heads of a group share one KV head. Query i sits at
absolute position ``Skv - Sq + i`` (the queries are the last Sq
positions), key j at j. Causal and
sliding-window masks and the tanh logit softcap are supported. Scores,
the running max, the normaliser and the accumulator are float32; the
probabilities are rounded to v's type before the PV product.

:func:`flash_attention_torch` computes what the JAX package's
``kernels/ref.py::flash_attention_ref`` computes (float32 scores, the
-1e30 mask, softmax, probabilities cast to v's type). The CUDA source
``csrc/flash_attention.cu`` runs the online softmax of the Pallas
kernel: bfloat16 on the tensor cores (``wgmma``, K/V by TMA), float32
on the CUDA cores; :func:`flash_attention_cuda` launches the one for
q's type.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_NEG_INF = -1e30
_MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _attention_mask(sq: int, skv: int, *, causal: bool, window: int,
                    device=None) -> torch.Tensor:
    """(sq, skv) bool, True = attend: query i at ``skv - sq + i``."""
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version (the kernel's reference, and what the port
    runs for CPU tensors); the queries are the last Sq positions."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    # bf16 products are exact in float32: this is the kernel's
    # float32-accumulated dot product
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    logits = logits * (hd ** -0.5)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = _attention_mask(Sq, Skv, causal=causal, window=window,
                           device=q.device)
    logits = torch.where(mask, logits, _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
            + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/flash_attention.cu``) on the
    current stream; same contract as :func:`flash_attention_torch`.
    The ragged edges of Sq and Skv are masked in the kernel. Raises on
    inputs the kernel does not take and on a failed launch; it never
    falls back to the plain version."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention_cuda: q and k must be 4-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"flash_attention_cuda needs CUDA tensors on "
                             f"one device; {name} is on {x.device}")
        if x.dtype not in _DTYPES or x.dtype != q.dtype:
            raise ValueError(f"flash_attention_cuda: {name} must be float32 "
                             f"or bfloat16 like q ({q.dtype}), got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             f"contiguous and 16-byte aligned")
    if tuple(k.shape) != (B, Skv, KV, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention_cuda: k and v must be "
                         f"{(B, Skv, KV, hd)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention_cuda: H={H} is not a multiple "
                         f"of KV={KV}")
    if hd % 8 or not 8 <= hd <= _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_cuda: head_dim {hd} must be a "
                         f"multiple of 8 in [8, {_MAX_HEAD_DIM}]")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device)
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Skv, H, KV, hd, Skv - Sq, int(causal),
            window, softcap, hd ** -0.5, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err}")
    build.LAUNCHES["flash_attention"] += 1
    return out

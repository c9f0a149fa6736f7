"""Diagonal linear recurrence h_t = a_t·h_{t-1} + b_t: the plain PyTorch
version and the CUDA kernel (counterpart of the JAX package's
``kernels/lru_scan.py``).

a, b (B, L, R) of one type; h0 (B, R) or None (zeros) -> h (B, L, R)
in a's type. The carry is float32; each channel (b, r) runs on its own.

:func:`lru_scan_torch` steps the recurrence in order, a multiply and an
add per step, as ``kernels/ref.py::lru_scan_ref`` defines it (the
oracle takes an associative scan, which rounds differently).
:func:`lru_scan_cuda` launches ``csrc/lru_scan.cu``, which does the same
operations in the same order, and masks ragged L and R itself (the JAX
wrapper pads them with a = 1, b = 0).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def lru_scan_torch(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version (the kernel's reference, and what the port
    runs for CPU tensors)."""
    B, L, R = a.shape
    af, bf = a.float(), b.float()
    h = torch.zeros((B, R), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    out = torch.empty((B, L, R), dtype=a.dtype, device=a.device)
    for t in range(L):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out


def _lib() -> ctypes.CDLL:
    lib = build.load("lru_scan")
    fn = lib.lru_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def lru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                  h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/lru_scan.cu``) on the current
    stream; same contract as :func:`lru_scan_torch`. Raises on inputs
    the kernel does not take and on a failed launch; it never falls back
    to the plain version."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"lru_scan_cuda: a and b must be one (B, L, R) "
                         f"shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    B, L, R = a.shape
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"lru_scan_cuda needs CUDA tensors on one "
                             f"device; {name} is on {t.device}")
        if name != "h0" and (t.dtype not in _DTYPES or t.dtype != a.dtype):
            raise ValueError(f"lru_scan_cuda: {name} must be float32 or "
                             f"bfloat16 like a ({a.dtype}), got {t.dtype}")
        if name != "h0" and not t.is_contiguous():
            raise ValueError(f"lru_scan_cuda: {name} must be contiguous")
    if h0 is not None:
        if tuple(h0.shape) != (B, R):
            raise ValueError(f"lru_scan_cuda: h0 must be {(B, R)}, got "
                             f"{tuple(h0.shape)}")
        h0 = h0.float().contiguous()
    out = torch.empty_like(a)
    if B == 0 or L == 0 or R == 0:
        return out
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device)
        err = lib.lru_scan_launch(
            a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), out.data_ptr(),
            _DTYPES[a.dtype], B, L, R, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"lru_scan kernel launch failed with CUDA error "
                           f"{err}")
    build.LAUNCHES["lru_scan"] += 1
    return out

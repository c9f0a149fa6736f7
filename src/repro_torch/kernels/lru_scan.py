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

The kernel has two routes, and :func:`_route` picks one from shape,
type and alignment alone: "tma" when a, b and the output start on
16-byte boundaries and a row of R values is a multiple of 16 bytes (R
% 4 == 0 in float32, R % 8 == 0 in bfloat16; every call of the hybrid
model), else "simple". The tma route feeds each block's slab of
channels through a ring of shared-memory tiles loaded by the Tensor
Memory Accelerator, so the loads run far ahead of the serial chain; the
simple route is one thread per channel with its loads 16 steps ahead.
Both walk each channel's time axis in order with the same two rounded
operations a step, so both equal :func:`lru_scan_torch` bit for bit.
No keyword or setting chooses a route, and a route that fails raises:
neither stands in for the other.

:class:`LruScan` is the kernel with a backward, for training on the
card (the JAX package differentiates its associative scan; this is the
gradient of the same function). Its backward is the recurrence run
from the end, lam_t = a_{t+1} lam_{t+1} + g_t, one launch of the same
kernel in reverse mode (:func:`lru_scan_reverse_cuda`, which reads
a_{t+1} where the forward reads a_t, so no shifted or flipped copy is
made), then db = lam, da_t = lam_t h_{t-1} and dh0 = a_0 lam_0 in two
elementwise products. It takes float32 a and b, what the hybrid's
``RecMixer`` passes.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"simple": 0, "tma": 1}


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


def _route(R: int, dtype: torch.dtype, *ptrs: int) -> str:
    """The kernel's route for rows of ``R`` values of ``dtype`` at the
    device addresses ``ptrs`` (a, b or g, and the output): "tma" when
    every address and a row's bytes are multiples of 16 (the Tensor
    Memory Accelerator's rules), else "simple"."""
    if (R * dtype.itemsize) % 16 == 0 and all(p % 16 == 0 for p in ptrs):
        return "tma"
    return "simple"


def _lib() -> ctypes.CDLL:
    lib = build.load("lru_scan")
    fn, rev = lib.lru_scan_launch, lib.lru_scan_reverse_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rev.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        rev.restype = ctypes.c_int
    return lib


def _launch_forward(a, b, h0, out, route: str) -> None:
    """One forward launch on ``route``; raises on a CUDA error."""
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device)
        err = _lib().lru_scan_launch(
            a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), out.data_ptr(),
            _DTYPES[a.dtype], *a.shape, _ROUTES[route], stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"lru_scan kernel launch ({route} route) failed "
                           f"with CUDA error {err}")


def _launch_reverse(a, g, lam, route: str) -> None:
    """One reverse-mode launch on ``route``; raises on a CUDA error."""
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device)
        err = _lib().lru_scan_reverse_launch(
            a.data_ptr(), g.data_ptr(), lam.data_ptr(), *a.shape,
            _ROUTES[route], stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"lru_scan reverse kernel launch ({route} route) "
                           f"failed with CUDA error {err}")


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
    _launch_forward(a, b, h0, out, _route(R, a.dtype, a.data_ptr(),
                                          b.data_ptr(), out.data_ptr()))
    build.LAUNCHES["lru_scan"] += 1
    return out


def lru_scan_reverse_cuda(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The backward's recurrence on the card: lam (B, L, R) float32 with
    lam_{L-1} = g_{L-1} and lam_t = a_{t+1} lam_{t+1} + g_t, for float32
    contiguous CUDA ``a`` and ``g`` of one (B, L, R) shape. One launch of
    ``csrc/lru_scan.cu`` in reverse mode, counted as an ``lru_scan``
    launch; raises on other inputs and on a failed launch."""
    if a.dim() != 3 or g.shape != a.shape:
        raise ValueError(f"lru_scan_reverse_cuda: a and g must be one "
                         f"(B, L, R) shape, got {tuple(a.shape)} and "
                         f"{tuple(g.shape)}")
    for name, t in (("a", a), ("g", g)):
        if t.device.type != "cuda" or t.device != a.device \
                or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"lru_scan_reverse_cuda: {name} must be a "
                             f"contiguous float32 CUDA tensor on a's "
                             f"device, got {t.dtype} on {t.device}")
    B, L, R = a.shape
    lam = torch.empty_like(a)
    if B == 0 or L == 0 or R == 0:
        return lam
    _launch_reverse(a, g, lam, _route(R, a.dtype, a.data_ptr(),
                                      g.data_ptr(), lam.data_ptr()))
    build.LAUNCHES["lru_scan"] += 1
    return lam


class LruScan(torch.autograd.Function):
    """``lru_scan_cuda`` with a backward on the card (float32 a, b and
    h0). Forward: one launch, saving a, h and h0. Backward: one reverse
    launch for lam, then da_t = lam_t h_{t-1} (h_{-1} = h0, or 0),
    db = lam, dh0 = a_0 lam_0. Each is the multiply or add autograd
    through :func:`lru_scan_torch` does, so the gradients agree with it
    bit for bit."""

    @staticmethod
    def forward(ctx, a, b, h0=None):
        for name, t in (("a", a), ("b", b), ("h0", h0)):
            if t is not None and t.dtype != torch.float32:
                raise ValueError(f"LruScan differentiates float32 inputs; "
                                 f"{name} is {t.dtype}")
        h = lru_scan_cuda(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        lam = lru_scan_reverse_cuda(a, g.contiguous())
        da = db = dh0 = None
        if ctx.needs_input_grad[0]:
            da = torch.empty_like(lam)
            da[:, 1:] = lam[:, 1:] * h[:, :-1]
            if h0 is None:
                da[:, 0] = 0.0
            else:
                da[:, 0] = lam[:, 0] * h0
        if ctx.needs_input_grad[1]:
            db = lam
        if h0 is not None and ctx.needs_input_grad[2]:
            dh0 = a[:, 0] * lam[:, 0]
        return da, db, dh0

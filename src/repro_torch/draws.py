"""Counter-based random draws that give the same bits on every device.

A ``torch.Generator``'s CUDA stream differs from its CPU stream, so a
value drawn from one on the card is not the value drawn on the CPU.
The draws here are functions of integers instead: element ``i`` of a
draw keyed ``key`` hashes ``(key, i)`` in int64 tensor ops, which are
exact on any device, and its value does not depend on how the caller
cuts the draw into slices.

Normals. The inverse normal CDF turns each uniform into a normal. It is
built in float64 from operations that IEEE 754 rounds exactly, each run
as its own eager op (``+``, ``-``, ``*``, ``/`` of two tensors, ``sqrt``,
``frexp``, comparisons, ``where`` and indexing; no ``log``, ``exp``,
``erfinv``, fused multiply-add or division by a scalar, which a device
may compute as a multiplication by its reciprocal), so the CPU and the
card compute the same bits:

* the central region (0.02425 <= p <= 0.97575) is Acklam's rational
  approximation in ``q = p - 0.5`` (relative error below 1.2e-9, under a
  float32 step);
* the tails take Acklam's rational function of ``sqrt(-2 log p)``, where
  ``log`` is built from ``frexp`` (the exponent times ln 2) and the
  series ``2 atanh(s)`` of the mantissa in ``s = (m - 1) / (m + 1)``,
  12 terms, ``|s| <= 0.172``.

Uniforms carry 32 bits, ``(h + 0.5) / 2**32`` for a 32-bit hash ``h``,
so they lie in (0, 1) and the normals in about (-6.2, 6.2).
"""
from __future__ import annotations

import math

import torch

I64 = torch.int64
F64 = torch.float64
M32 = 0xFFFFFFFF
MIX = 0x45D9F3B       # odd, < 2**31: a 32-bit product stays below 2**63
# elements a slice of a draw handles at a time: bounds the int64 and
# float64 temporaries (256 MiB each). A slice is about 40 kernels and a
# host read, whatever its size, so a smaller one makes a full-size init
# wait on the host (qwen3-moe-30b-a3b's 30.5e9 parameters took 21.0 s in
# slices of 2^22 on the H100)
SLICE = 1 << 25

# Acklam's coefficients (central numerator a, denominator b; tails c, d)
_A = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
      1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
_B = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
      6.680131188771972e+01, -1.328068155288572e+01, 1.0)
_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
      -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
      3.754408661907416e+00, 1.0)
_P_LOW = 0.02425
# 2 atanh(s) = 2 s (1 + s^2/3 + s^4/5 + ...), highest power first
_ATANH = tuple(1.0 / (2 * k + 1) for k in range(11, -1, -1))
_LN2 = math.log(2.0)
_SQRT_HALF = math.sqrt(0.5)


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * MIX) & M32
    x = x ^ (x >> 16)
    x = (x * MIX) & M32
    return x ^ (x >> 16)


def _mix32_host(x: int) -> int:
    """:func:`mix32` of one integer, taken mod 2**32, on the host."""
    return int(mix32(torch.tensor(x & M32, dtype=I64)))


def key(*words: int) -> int:
    """A draw's key from integers (a seed, a leaf index, ...)."""
    k = 0
    for w in words:
        k = _mix32_host(k ^ _mix32_host(w))
    return k


def uniforms(k: int, start: int, n: int, device) -> torch.Tensor:
    """(n,) float64 uniforms in (0, 1): elements ``start .. start+n-1``
    of the draw keyed ``k``. Element i is ``(h + 0.5) / 2**32`` with
    ``h = mix32(mix32(i & 0xFFFFFFFF) ^ mix32(k ^ (i >> 32)))``: the key
    enters after a hash of the index, so two keys give unrelated orders
    of the same values, not one order shifted (``mix32(i ^ k)`` would
    make two power-of-two-wide matrices each other's row and column
    permutations). The high word is folded into the key on the host,
    one piece per 2**32 block."""
    out = torch.empty(n, dtype=F64, device=device)
    i, end = start, start + n
    while i < end:
        hi = i >> 32
        stop = min(end, (hi + 1) << 32)
        kh = _mix32_host(k ^ hi)
        lo = torch.arange(i & M32, ((stop - 1) & M32) + 1, dtype=I64,
                          device=device)
        h = mix32(mix32(lo) ^ kh).to(F64)
        out[i - start:stop - start] = h.add_(0.5).mul_(2.0 ** -32)
        i = stop
    return out


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """sum_k coeffs[k] x^(n-k), one multiply and one add a step."""
    acc = x * coeffs[0]
    acc.add_(coeffs[1])
    for c in coeffs[2:]:
        acc.mul_(x).add_(c)
    return acc


def _log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal float64 values from exactly
    rounded operations: x = m 2^e with m in [sqrt(1/2), sqrt(2))."""
    m, e = torch.frexp(x)
    small = m < _SQRT_HALF
    m = torch.where(small, m * 2.0, m)
    e = (e - small.to(e.dtype)).to(F64)
    s = (m - 1.0) / (m + 1.0)
    poly = _horner(s * s, _ATANH)
    return e.mul_(_LN2).add_(poly.mul_(s).mul_(2.0))


def ppf(p: torch.Tensor) -> torch.Tensor:
    """The standard normal's inverse CDF at float64 ``p`` in (0, 1)."""
    q = p - 0.5
    r = q * q
    x = _horner(r, _A).mul_(q) / _horner(r, _B)
    tail = ((p < _P_LOW) | (p > 1.0 - _P_LOW)).nonzero().squeeze(1)
    if tail.numel():
        pt = p[tail]
        lower = pt < 0.5
        m = torch.where(lower, pt, 1.0 - pt)
        t = torch.sqrt(_log(m).mul_(-2.0))
        xt = _horner(t, _C) / _horner(t, _D)
        x[tail] = torch.where(lower, xt, -xt)
    return x


def normals(k: int, start: int, n: int, device) -> torch.Tensor:
    """(n,) float64 standard normals: elements ``start .. start+n-1`` of
    the draw keyed ``k``, the same bits on every device."""
    return ppf(uniforms(k, start, n, device))

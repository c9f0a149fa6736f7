"""Dispatch wrappers for the port's kernels.

Dispatch is by device: a CUDA tensor goes to the hand-written kernel,
a CPU tensor to its plain PyTorch version. There is no fallback from
the kernel to the plain version. A meta tensor (the dry-run,
``launch/dryrun.py``) takes the kernel's route without the kernel:
``flash_attention``, ``ssd_chunk`` and ``lru_scan`` return a meta
tensor of the kernel's output shape and type, do no arithmetic, count
no launch, and add the call's FLOPs to ``META_FLOPS``
(``schedule_step`` has no meta route). The flash and SSD kernels have no
backward: on a CUDA input that requires grad, with grad mode on, their
wrappers raise (training takes their plain versions by route, as the
JAX package trains through jnp). The LRU kernel has one: such an input
goes through ``lru_scan.LruScan``, whose backward launches the kernel
in reverse mode.

``LAUNCHES`` counts kernel launches per kernel name, one dict over all
kernels (a plain integer each, raised by each CUDA wrapper once its
launch has succeeded) so a run can show that its main path went through
the kernel. When ``KERNEL_EVENTS`` is a list, each ``schedule_step``
launch also appends the (start, end) CUDA events that the wrapper records
around its one kernel (timing instrumentation; off by default).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import PAPER_S
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lru_scan as _ls
from repro_torch.kernels import schedule_step as _ss
from repro_torch.kernels import ssd_chunk as _sc

LAUNCHES = build.LAUNCHES
META_FLOPS = build.META_FLOPS
KERNEL_EVENTS = None
# Private test hook: True sends CUDA tensors of ``schedule_step``,
# ``ssd_chunk`` and ``lru_scan`` to the plain version too, and
# ``models.attention.attend`` to its plain path (the one place attention
# tests it), so a run on the card can be held against its own plain path.
_FORCE_PLAIN = False
# the JAX flash wrapper's default block, which sets its alignment rule
_JAX_BLOCK = 128


def normalizers(demand, gp, cand, node_cap):
    """Eq. 3 normalizers over the candidates, clamped like the JAX
    wrapper (``max(..., 1e-12)``): (max_sz, max_gp), f32 scalars; with
    a leading batch axis (demand (B, J, 3), gp/cand (B, J), node_cap
    (3,) or (B, 3)) one pair per row, each (B,)."""
    sz = _ss.size_eq1(demand.float(), node_cap.float().unsqueeze(-2))
    max_sz = torch.where(cand, sz, 0.0).amax(-1).clamp(min=1e-12)
    max_gp = torch.where(cand, gp.float(), 0.0).amax(-1).clamp(min=1e-12)
    return max_sz, max_gp


def _refuse_grad(name: str, *tensors) -> None:
    """A CUDA kernel has no backward: its output would carry no
    ``grad_fn``, and a loss through a residual stream would quietly give
    the inputs' parameters no gradient. So a call that autograd would
    record raises instead (training takes the plain path by route)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {name} kernel has no backward: an input requires grad "
            f"with grad mode on (train through the plain path, or call "
            f"under torch.no_grad())")


def schedule_step(demand, gp, width, queue_key, assign, free,
                  pending_free, cand, under, be_q, te_demand, node_cap,
                  *, s=PAPER_S, norms=None, akey=None) -> _ss.SchedulePass:
    """One fused schedule pass over the (jobs, nodes) tile — Eq. 3
    scoring, Eq. 2 best-victim-node reduction, Eq. 4 masked argmin,
    fit counts now and promised, and the BE head / first-fit /
    skip-count scan.

    ``demand`` (J, 3); ``assign`` (J, M) bool; ``free`` and
    ``pending_free`` (M, 3); ``gp``/``queue_key`` (J,) f32; ``width``
    (J,) i32; ``cand``/``under``/``be_q`` (J,) bool; ``s`` a float or a
    0-d f32 tensor. With a leading batch axis B on every per-job and
    per-node argument, ``te_demand`` is (3,) or (B, 3), ``s`` (B,) and
    the normalizers are per row. ``norms`` is the ``(max_sz, max_gp)``
    pair of :func:`normalizers` when the caller already holds it (a
    ``cand`` mask fixed for a run); otherwise it is computed here.
    ``akey`` ((J,) or (B, J) f32, or None) breaks the victim's score
    ties by the smallest key before the lowest index."""
    max_sz, max_gp = normalizers(demand, gp, cand, node_cap) \
        if norms is None else norms
    args = (demand, gp, width, queue_key, assign, free, pending_free, cand,
            under, be_q, te_demand, node_cap, max_sz, max_gp, s, akey)
    if demand.device.type != "cuda" or _FORCE_PLAIN:
        return _ss.schedule_step_torch(*args)
    return _ss.schedule_step_cuda(*args, events=KERNEL_EVENTS)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """GQA flash attention, q (B, Sq, H, hd), k/v (B, Skv, KV, hd).

    The contract of the JAX wrapper: query i sits at absolute position
    Skv - Sq + i (the queries are the last Sq positions). The JAX
    wrapper pads Sq and Skv to multiples of its 128-row blocks and
    relies on the causal mask to hide the padded keys; the CUDA kernel
    masks the ragged edge itself instead, and the plain version needs
    no blocks. As there, non-causal attention over lengths that are not
    multiples of 128 raises ``ValueError``."""
    Sq, Skv = q.shape[1], k.shape[1]
    if not causal and (Sq % _JAX_BLOCK or Skv % _JAX_BLOCK):
        raise ValueError("non-causal attention requires block-aligned "
                         "Sq and Skv (padded keys would be attended)")
    if q.device.type not in ("cuda", "meta"):
        return _fa.flash_attention_torch(q, k, v, causal=causal,
                                         window=window, softcap=softcap)
    _refuse_grad("flash_attention", q, k, v)
    fn = _fa.flash_attention_cuda if q.device.type == "cuda" \
        else _fa.flash_attention_meta
    return fn(q, k, v, causal=causal, window=window, softcap=softcap)


def ssd_chunk(xdt, loga, Bm, Cm):
    """Mamba-2 intra-chunk SSD with zero initial state, chunks of
    Q = min(256, L): xdt (B, L, H, P), loga (B, L, H), Bm/Cm (B, L, H,
    N) -> y (B, L, H, P); see ``kernels/ssd_chunk.py``. Unlike the JAX
    wrapper, L need not be a multiple of Q (the last chunk is shorter)."""
    if xdt.device.type not in ("cuda", "meta") or _FORCE_PLAIN:
        return _sc.ssd_chunk_torch(xdt, loga, Bm, Cm)
    _refuse_grad("ssd_chunk", xdt, loga, Bm, Cm)
    fn = _sc.ssd_chunk_cuda if xdt.device.type == "cuda" \
        else _sc.ssd_chunk_meta
    return fn(xdt, loga, Bm, Cm)


def lru_scan(a, b, h0=None):
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t with a float32
    carry: a, b (B, L, R), h0 (B, R) or None -> h (B, L, R) in a's type;
    see ``kernels/lru_scan.py``. The kernel masks ragged L and R where
    the JAX wrapper pads them with a = 1, b = 0. On a CUDA input that
    requires grad (grad mode on) the call goes through
    ``lru_scan.LruScan``, the kernel with its backward, which takes
    float32 inputs only; the CPU's plain version is differentiated by
    autograd."""
    if a.device.type not in ("cuda", "meta") or _FORCE_PLAIN:
        return _ls.lru_scan_torch(a, b, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        return _ls.LruScan.apply(a, b, h0)
    fn = _ls.lru_scan_cuda if a.device.type == "cuda" else _ls.lru_scan_meta
    return fn(a, b, h0)

"""Fused schedule pass: the plain PyTorch version and the CUDA kernel.

One evaluation of everything a scheduler pass consumes over the
``(jobs, nodes)`` tile (counterpart of the JAX package's
``kernels/schedule_step.py``):

* ``scores``   (J,)  f32 — Eq. 3: size/max_sz + s*(gp/max_gp);
* ``fits``     (J,M) i32 — free covers the job's per-node demand;
* ``fit_now``  (J,)  i32 — row sums of ``fits``;
* ``fit_pend`` (J,)  i32 — the same counts against free + pending_free;
* ``victim``   ()    i32 — Eq. 4 argmin over cand & under & Eq. 2
  (eligibility against each candidate's BEST assigned node), -1 if none;
  ties go to the smallest ``akey`` when one is given (the stream
  engine's global arrival order), then to the lowest index;
* ``be_head``  ()    i32 — min-queue-key job of ``be_q``, -1 if empty;
* ``be_pick``  ()    i32 — min-queue-key job of ``be_q`` that fits now;
* ``nskip``    ()    i32 — non-fitting ``be_q`` jobs keyed ahead of it.

Both functions take an optional leading batch axis (B, J, ...) with
``max_sz``/``max_gp``/``s`` of shape (B,). :func:`schedule_step_torch`
fixes the operation order (explicit sums, no ``.sum(-1)`` over the
resource axis) so that the CUDA kernel ``csrc/schedule_step.cu``
matches it bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.engine.placement import FIT_EPS
from repro_torch.kernels import build

_INF = float("inf")
_TILE = 256          # jobs per tile of the kernel (kTile)
# The kernel takes J, M and its B * ceil(J / 256) tiles as 32-bit ints
# and walks its nodes 640 at a time (m0 + 640 must not overflow); every
# offset that grows with J or M is 64-bit. So each is capped here, far
# above any real cluster; the (J, M) int32 ``fits`` output (4 bytes a
# job and node) meets the card's memory long before.
_MAX_DIM = 2 ** 31 - 1024


class SchedulePass(NamedTuple):
    """Outputs of one fused schedule pass (see module docstring)."""
    scores: torch.Tensor      # (J,)  f32
    fits: torch.Tensor        # (J, M) i32
    fit_now: torch.Tensor     # (J,)  i32
    fit_pend: torch.Tensor    # (J,)  i32
    victim: torch.Tensor      # ()    i32, -1 sentinel
    be_head: torch.Tensor     # ()    i32, -1 sentinel
    be_pick: torch.Tensor     # ()    i32, -1 sentinel
    nskip: torch.Tensor       # ()    i32


def size_eq1(demand: torch.Tensor, node_cap: torch.Tensor) -> torch.Tensor:
    """Eq. 1, ||demand / node_cap||_2 over the last axis, in the fixed
    order sqrt((x0*x0 + x1*x1) + x2*x2) the kernel repeats.

    The root is taken in float64 and rounded to float32: PyTorch's CPU
    float32 sqrt can round a near-tie the wrong way, while the float64
    root rounded once more is the correctly rounded float32 root (as
    ``sqrtf`` and XLA give it)."""
    x = demand / node_cap
    sq = (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) \
        + x[..., 2] * x[..., 2]
    return torch.sqrt(sq.to(torch.float64)).to(torch.float32)


def covers(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a >= b`` on all three resources of the last axis."""
    return (a[..., 0] >= b[..., 0]) & (a[..., 1] >= b[..., 1]) \
        & (a[..., 2] >= b[..., 2])


def schedule_step_torch(demand, gp, width, queue_key, assign, free,
                        pending_free, cand, under, be_q, te_demand,
                        node_cap, max_sz, max_gp, s,
                        akey=None) -> SchedulePass:
    """Plain PyTorch version of the fused pass (the CUDA kernel's
    reference, and what the port runs for CPU tensors).

    demand (...,J,3) f32; gp/queue_key (...,J) f32; width (...,J) i32;
    assign (...,J,M) bool; free/pending_free (...,M,3) f32;
    cand/under/be_q (...,J) bool; te_demand/node_cap (...,3);
    max_sz/max_gp/s scalars or (...,) (normalizers pre-clamped);
    ``akey`` None or (...,J) f32, the victim's tie-break."""
    dev = demand.device
    demand = demand.float()
    free = free.float()

    def col(x):                       # scalar or (B,) -> broadcast over J
        return torch.as_tensor(x, dtype=torch.float32, device=dev)[..., None]

    size = size_eq1(demand, node_cap.unsqueeze(-2))
    scores = size / col(max_sz) + col(s) * (gp / col(max_gp))
    need = (demand - FIT_EPS).unsqueeze(-2)                 # (...,J,1,3)
    fr = free.unsqueeze(-3)                                 # (...,1,M,3)
    fits_b = covers(fr, need)                                # (...,J,M)
    fit_now = fits_b.sum(-1, dtype=torch.int32)
    fit_pend = covers((free + pending_free).unsqueeze(-3), need) \
        .sum(-1, dtype=torch.int32)
    # Eq. 2 against each candidate's best assigned node
    sl = (fr + demand.unsqueeze(-2)) - te_demand[..., None, None, :]
    slack = torch.minimum(torch.minimum(sl[..., 0], sl[..., 1]), sl[..., 2])
    best = torch.where(assign, slack, -_INF).amax(-1)
    allowed = cand & under & (best >= -FIT_EPS)
    masked = torch.where(allowed, scores, _INF)
    if akey is None:
        first = masked.argmin(-1)
    else:                 # (score, akey, index) order
        tied = allowed & (scores == masked.amin(-1, keepdim=True))
        first = torch.where(tied, akey, _INF).argmin(-1)
    victim = torch.where(allowed.any(-1), first, -1)
    # BE queue scan: head, first fit in key order, skips ahead of it
    be_head = torch.where(be_q.any(-1),
                          torch.where(be_q, queue_key, _INF).argmin(-1), -1)
    ok = fit_now >= width
    okq = be_q & ok
    has_pick = okq.any(-1)
    be_pick = torch.where(has_pick,
                          torch.where(okq, queue_key, _INF).argmin(-1), -1)
    key_at = queue_key.gather(-1, be_pick.clamp(min=0).unsqueeze(-1))
    pick_key = torch.where(has_pick.unsqueeze(-1), key_at, _INF)
    nskip = (be_q & ~ok & (queue_key < pick_key)).sum(-1, dtype=torch.int32)
    return SchedulePass(scores, fits_b.to(torch.int32), fit_now, fit_pend,
                        victim.to(torch.int32), be_head.to(torch.int32),
                        be_pick.to(torch.int32), nskip)


_ARGTYPES = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = build.load("schedule_step")
    fn = lib.schedule_step_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(name, x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"schedule_step_cuda: {name} must be {dtype} of "
                         f"shape {tuple(shape)}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"schedule_step_cuda: {name} must be contiguous")


def schedule_step_cuda(demand, gp, width, queue_key, assign, free,
                       pending_free, cand, under, be_q, te_demand,
                       node_cap, max_sz, max_gp, s, akey=None, *,
                       events=None) -> SchedulePass:
    """Launch the CUDA kernel (``csrc/schedule_step.cu``, one
    cooperative launch a pass) on the current stream; same contract as
    :func:`schedule_step_torch`. Unbatched inputs get a batch axis of 1
    and lose it on return. Raises on inputs the kernel does not take and
    on a failed launch (a refused cooperative launch included); it never
    falls back to the plain version. When ``events`` is a list, a
    (start, end) pair of CUDA events recorded right around the launch is
    appended to it (kernel timing)."""
    batched = demand.dim() == 3
    if not batched:
        demand, gp, width, queue_key, assign, free, pending_free, cand, \
            under, be_q = (x.unsqueeze(0) for x in (
                demand, gp, width, queue_key, assign, free, pending_free,
                cand, under, be_q))
        if akey is not None:
            akey = akey.unsqueeze(0)
    B, J, _ = demand.shape
    M = free.shape[1]
    dev = demand.device
    if dev.type != "cuda":
        raise ValueError(f"schedule_step_cuda needs CUDA tensors, got {dev}")
    n_tiles = (J + _TILE - 1) // _TILE
    if not (1 <= J <= _MAX_DIM and 1 <= M <= _MAX_DIM
            and B * n_tiles <= _MAX_DIM):
        raise ValueError(f"schedule_step_cuda: need 1 <= J, M <= {_MAX_DIM}"
                         f" and B * ceil(J / {_TILE}) <= {_MAX_DIM} (32-bit "
                         f"indices in the kernel), got B={B}, J={J}, M={M}")

    def per_row(x, n):                # (3,)/(B,3) or ()/(B,) -> (B, n)
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return x.reshape(-1, n).expand(B, n).contiguous()

    te_demand, node_cap = per_row(te_demand, 3), per_row(node_cap, 3)
    max_sz, max_gp, s = (per_row(x, 1).reshape(B)
                         for x in (max_sz, max_gp, s))
    for name, x, dtype, shape in (
            ("demand", demand, torch.float32, (B, J, 3)),
            ("gp", gp, torch.float32, (B, J)),
            ("width", width, torch.int32, (B, J)),
            ("queue_key", queue_key, torch.float32, (B, J)),
            ("assign", assign, torch.bool, (B, J, M)),
            ("free", free, torch.float32, (B, M, 3)),
            ("pending_free", pending_free, torch.float32, (B, M, 3)),
            ("cand", cand, torch.bool, (B, J)),
            ("under", under, torch.bool, (B, J)),
            ("be_q", be_q, torch.bool, (B, J)),
            ("akey", akey, torch.float32, (B, J))):
        if x is None:                 # no akey: ties by index alone
            continue
        _check(name, x, dtype, shape)
        if x.device != dev:
            raise ValueError(f"schedule_step_cuda: {name} is on {x.device},"
                             f" demand on {dev}")

    scores = torch.empty((B, J), dtype=torch.float32, device=dev)
    fits = torch.empty((B, J, M), dtype=torch.int32, device=dev)
    fit_now = torch.empty((B, J), dtype=torch.int32, device=dev)
    fit_pend = torch.empty((B, J), dtype=torch.int32, device=dev)
    out = torch.empty((B, 4), dtype=torch.int32, device=dev)
    # per tile: the three argmins' values and the victim's akey
    part_val = torch.empty((B, n_tiles, 4), dtype=torch.float32, device=dev)
    part_idx = torch.empty((B, n_tiles, 3), dtype=torch.int32, device=dev)
    lib = _lib()
    ptrs = [x.data_ptr() for x in (
        demand, gp, width, queue_key, assign, free, pending_free, cand,
        under, be_q, te_demand, node_cap, max_sz, max_gp, s, scores, fits,
        fit_now, fit_pend, out, part_val, part_idx)] \
        + [None if akey is None else akey.data_ptr()]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        if events is not None:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record(stream)
        err = lib.schedule_step_launch(*ptrs, B, J, M, stream.cuda_stream)
        if events is not None:
            end.record(stream)
            events.append((start, end))
    if err != 0:
        raise RuntimeError(f"schedule_step kernel launch failed with CUDA "
                           f"error {err}")
    build.LAUNCHES["schedule_step"] += 1
    ps = SchedulePass(scores, fits, fit_now, fit_pend, out[:, 0], out[:, 1],
                      out[:, 2], out[:, 3])
    return ps if batched else SchedulePass(*(x[0] for x in ps))

"""Dispatch wrappers for the port's kernels.

Dispatch is by device: a CUDA tensor goes to the hand-written kernel,
a CPU tensor to its plain PyTorch version. There is no fallback from
the kernel to the plain version.

``LAUNCHES`` counts kernel launches per kernel name (a plain integer,
raised by each CUDA wrapper once its launch has succeeded) so a run can
show that its main path went through the kernel. When ``KERNEL_EVENTS``
is a list, each launch also appends the CUDA events that the wrapper
records around its kernels (timing instrumentation; off by default).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import PAPER_S
from repro_torch.kernels import schedule_step as _ss

LAUNCHES = _ss.LAUNCHES
KERNEL_EVENTS = None
# Private test hook: True sends CUDA tensors to the plain version too,
# so a run on the card can be held against its own plain path.
_FORCE_PLAIN = False


def normalizers(demand, gp, cand, node_cap):
    """Eq. 3 normalizers over the candidates, clamped like the JAX
    wrapper (``max(..., 1e-12)``): (max_sz, max_gp), f32 scalars."""
    sz = _ss.size_eq1(demand.float(), node_cap.float())
    max_sz = torch.where(cand, sz, 0.0).max().clamp(min=1e-12)
    max_gp = torch.where(cand, gp.float(), 0.0).max().clamp(min=1e-12)
    return max_sz, max_gp


def schedule_step(demand, gp, width, queue_key, assign, free,
                  pending_free, cand, under, be_q, te_demand, node_cap,
                  *, s=PAPER_S, norms=None) -> _ss.SchedulePass:
    """One fused schedule pass over the (jobs, nodes) tile — Eq. 3
    scoring, Eq. 2 best-victim-node reduction, Eq. 4 masked argmin,
    fit counts now and promised, and the BE head / first-fit /
    skip-count scan.

    ``demand`` (J, 3); ``assign`` (J, M) bool; ``free`` and
    ``pending_free`` (M, 3); ``gp``/``queue_key`` (J,) f32; ``width``
    (J,) i32; ``cand``/``under``/``be_q`` (J,) bool; ``s`` a float or a
    0-d f32 tensor. ``norms`` is the ``(max_sz, max_gp)`` pair of
    :func:`normalizers` when the caller already holds it (a ``cand``
    mask fixed for a run); otherwise it is computed here."""
    max_sz, max_gp = normalizers(demand, gp, cand, node_cap) \
        if norms is None else norms
    args = (demand, gp, width, queue_key, assign, free, pending_free, cand,
            under, be_q, te_demand, node_cap, max_sz, max_gp, s)
    if demand.device.type != "cuda" or _FORCE_PLAIN:
        return _ss.schedule_step_torch(*args)
    return _ss.schedule_step_cuda(*args, events=KERNEL_EVENTS)

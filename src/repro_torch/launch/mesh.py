"""The sweep's device choice (the port's side of the JAX package's
``launch/mesh.py::mesh_for_sweep``).

The JAX sweep fabric shards its trial table over a 1-D device mesh.
The port runs a table on one device; sharding it over several (one
process per device) is a later item, multi-device sweeps, and until it
lands the port has no counterpart of ``sharding/trials.py``. So
:func:`mesh_for_sweep` runs a sweep on one device unless the caller
asks for more, keeps the JAX function's warnings for a request that
cannot be met, and raises for a request of several devices that could
be.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch import device as _device


def _available(dev: torch.device) -> int:
    """Devices of ``dev``'s kind a sweep could use: the CUDA devices,
    or the host as one device."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def mesh_for_sweep(n_trials: Optional[int] = None,
                   devices: Optional[int] = None, device=None):
    """How many devices a sweep of ``n_trials`` trials uses on
    ``device``'s kind (the current CUDA device unless given): ``None``,
    the single-device run, which is all the port runs.

    ``devices=None`` means one device (the JAX function takes every
    device present; the port runs a table on ``device`` until
    multi-device sweeps land). Otherwise the JAX function's rules:
    ``min(devices, n_trials)``; asking for more devices than are
    present warns (``UserWarning``), never silently, and falls back to
    those present; a request for more than one that falls back to one
    warns again. Where an explicit request comes to more than one
    device, this raises ``NotImplementedError``: multi-device sweeps
    are not ported."""
    avail = _available(_device.resolve(device))
    want = 1 if devices is None else int(devices)
    if want > avail:
        warnings.warn(
            f"mesh_for_sweep: {want} devices requested but only {avail} "
            f"present; falling back to {avail}", stacklevel=2)
        want = avail
    if n_trials is not None:
        want = min(want, max(int(n_trials), 1))
    if want <= 1:
        if devices is not None and devices > 1:
            warnings.warn(
                "mesh_for_sweep: falling back to a SINGLE-DEVICE sweep "
                f"(requested {devices} devices, usable {want})",
                stacklevel=2)
        return None
    raise NotImplementedError(
        f"a sweep over {want} devices needs multi-device sweeps, which "
        "the port does not have yet (ROADMAP.md); pass devices=1 (or "
        "none) to run it on one device")

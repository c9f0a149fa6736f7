"""Meshes for the dry-run, and the sweep's device choice (the port's
side of the JAX package's ``launch/mesh.py``).

A :class:`Mesh` here is a plain description, axis names and sizes,
with no devices: PyTorch has no SPMD compiler that lowers a model onto
it, so the dry-run (``launch/dryrun.py``) resolves each plan on it and
accounts one device's share (``sharding/plans.py``).
:func:`make_production_mesh` keeps the JAX package's shapes, so each
plan can be held against JAX's on the same mesh.

The JAX sweep fabric shards its trial table over a 1-D device mesh. The
port shards it over processes, one per device
(``repro_torch.sharding.trials``): :func:`mesh_for_sweep` names the
devices a sweep runs on, with the JAX function's rules and warnings.
On the CPU the host's processes stand in for JAX's forced host devices
(``--xla_force_host_platform_device_count``): the host offers one
process per core, ``os.cpu_count()``.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import device as _device


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a device mesh (JAX's ``Mesh`` without its
    devices): ``shape`` maps each name to its size, in order."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) ("data", "model") for one 256-device pod; (2, 16, 16)
    with a leading "pod" axis for the 512-device two-pod deployment."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(device=None) -> Mesh:
    """(n_devices, 1) ("data", "model") over the devices of ``device``'s
    kind (default: the CUDA devices; raises without one): the CUDA
    devices present, or one host for ``device="cpu"``."""
    dev = _device.resolve(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return Mesh(("data", "model"), (n, 1))


def _available(device) -> int:
    """Devices of ``device``'s kind a sweep could use: the CUDA devices,
    or on the CPU one process per core."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def _device_list(device, n: int) -> List[str]:
    """``n`` devices of ``device``'s kind for a sharded sweep: the CUDA
    devices 0 .. n-1, or the host ``n`` times (one process each)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [f"cuda:{i}" for i in range(n)]
    return [dev.type] * n


def mesh_for_sweep(n_trials: Optional[int] = None,
                   devices: Optional[int] = None,
                   device=None) -> Optional[List[str]]:
    """The devices a sweep of ``n_trials`` trials runs on, of
    ``device``'s kind (the current CUDA device unless given): ``None``
    for the single-device run (in the calling process), else the list
    of :func:`_device_list`, one process each.

    ``devices=None`` means one device (the JAX function takes every
    device present; the port runs a table on ``device`` unless asked
    for more). Otherwise the JAX function's rules: ``min(devices,
    n_trials)``; asking for more devices than are present
    (:func:`_available`) warns (``UserWarning``), never silently, and
    falls back to those present; a request for more than one that falls
    back to one warns again."""
    dev = _device.resolve(device)
    avail = _available(dev)
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
    return _device_list(dev, want)

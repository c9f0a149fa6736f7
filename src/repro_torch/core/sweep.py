"""Simulation sweeps: thin wrappers over the port's sweep fabric
(``core/sweep_fabric.py``), with the JAX package's ``core/sweep.py``
names and dict-of-arrays return shapes.

The sensitivity studies (Figs. 4-7) are grids of independent
simulations (policy × s × P × workload seed). Each wrapper builds one
trial table for its grid and runs it through ``sweep_fabric.run_table``
in one batched engine run on ``device`` (the current CUDA device unless
the caller passes one; ``device="cpu"`` runs the plain path). The JAX
wrappers' ``mesh`` and ``trial_axes`` arguments pick a JAX device mesh
and have no counterpart here: ``devices`` follows
``launch.mesh.mesh_for_sweep`` (one device by default; N shards the
table over N devices, one process each, with the same results), and
``api.mesh_for_sweep(n_trials, devices, device)`` names the devices a
call uses. New code wanting per-job pooling, or the padding and device
counts of a sharded run (``SweepResult.n_padded``, ``n_devices``), uses
``sweep_fabric.run_table`` directly; callers reach both through
``repro_torch.api``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch import device as _device
from repro_torch import scenarios
from repro_torch.configs.cluster import SimConfig
from repro_torch.core import sweep_fabric, workload
from repro_torch.core.sim_torch import Jobs
from repro_torch.core.sweep_fabric import stack_jobsets


def run_sweep(cfg: SimConfig, jobs: Jobs, s_vals, P_vals, seeds,
              time_mode: Optional[str] = None,
              devices: Optional[int] = None,
              device=None) -> Dict[str, np.ndarray]:
    """Run T independent trials; trial t uses ``jobs[t]`` (stacked
    Jobs, every field (T, N, ...)), ``s_vals[t]``, ``P_vals[t]`` and
    ``seeds[t]`` (scalars broadcast). ``time_mode`` (default
    ``cfg.time_mode``) selects tick-stepped or event-compressed
    advancement (bit-identical results). Returns the classic per-trial
    summary dict (``sweep_fabric._trial_percentiles``)."""
    table = sweep_fabric.table_from_stacked(jobs, s_vals, P_vals, seeds)
    res = sweep_fabric.run_table(cfg, table, devices=devices,
                                 time_mode=time_mode, device=device)
    return res.stats


def _reshape(out: Dict[str, np.ndarray], a: int, b: int) -> Dict:
    return {k: v.reshape((a, b) + v.shape[1:]) for k, v in out.items()}


def sensitivity_grid(cfg: SimConfig, n_jobs: int, s_vals: Sequence[float],
                     seeds: Sequence[int],
                     time_mode: Optional[str] = None,
                     devices: Optional[int] = None,
                     device=None) -> Dict[str, np.ndarray]:
    """Fig. 4-style grid: all (s, seed) pairs on shared per-seed
    workloads (``workload.generate``), flattened into ONE fabric table.

    Returns arrays of shape (len(s_vals), len(seeds), ...)."""
    device = _device.resolve(device)          # fail before the build
    wl = dataclasses.replace(cfg.workload, n_jobs=n_jobs)
    base = dataclasses.replace(cfg, workload=wl)
    stacked = stack_jobsets([workload.generate(base, seed=sd)
                             for sd in seeds])
    ns, nt = len(s_vals), len(seeds)
    rep = stacked.map(lambda x: x.repeat((ns,) + (1,) * (x.dim() - 1)))
    s_flat = np.repeat(np.asarray(s_vals, np.float32), nt)
    P_flat = np.full(ns * nt, base.max_preemptions, np.int32)
    seed_flat = np.tile(np.asarray(seeds, np.uint32), ns)
    out = run_sweep(base, rep, s_flat, P_flat, seed_flat,
                    time_mode=time_mode, devices=devices, device=device)
    return _reshape(out, ns, nt)


def scenario_table(cfg: SimConfig, names: Sequence[str],
                   seeds: Sequence[int]) -> sweep_fabric.TrialTable:
    """The ragged multi-scenario grid as one fabric table: trial
    ``i * len(seeds) + j`` is scenario ``names[i]`` at ``seeds[j]``,
    even when the scenarios produce different job counts (sentinel
    padding, ``stack_jobsets``) or gang (multi-node) jobs; widths ride
    through the padding."""
    jobsets = [scenarios.build(name, dataclasses.replace(cfg, seed=sd))
               for name in names for sd in seeds]
    n = len(jobsets)
    return sweep_fabric.table_from_stacked(
        stack_jobsets(jobsets), np.full(n, cfg.s, np.float32),
        np.full(n, cfg.max_preemptions, np.int32),
        np.tile(np.asarray(seeds, np.uint32), len(names)))


def scenario_sweep(cfg: SimConfig, names: Sequence[str],
                   seeds: Sequence[int],
                   time_mode: Optional[str] = None,
                   devices: Optional[int] = None,
                   device=None) -> Dict[str, np.ndarray]:
    """Ragged multi-scenario grid (:func:`scenario_table`) in one
    fabric run.

    Returns arrays of shape (len(names), len(seeds), ...)."""
    device = _device.resolve(device)          # fail before the build
    res = sweep_fabric.run_table(cfg, scenario_table(cfg, names, seeds),
                                 devices=devices, time_mode=time_mode,
                                 device=device)
    return _reshape(res.stats, len(names), len(seeds))


# ``sweep.run``: the one entry point callers batch everything through.
run = run_sweep

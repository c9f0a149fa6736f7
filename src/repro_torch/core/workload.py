"""Synthetic workload generation (paper §4.2), host numpy.

The port's copy of the JAX package's paper-synthetic generator: the
same samplers drawing from the same ``numpy`` generator in the same
order, so every array (closed-loop submit times included) is
bit-identical to ``repro.core.workload.generate`` for the same config.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.cluster import ClassDists, SimConfig, TruncNormal
from repro_torch.core.simulator import FifoAdmission
from repro_torch.core.types import JobSet


def sample_trunc_normal(rng: np.random.Generator, d: TruncNormal,
                        size: int) -> np.ndarray:
    """Resampling-based truncated normal (the paper truncates a fit)."""
    out = rng.normal(d.mean, d.std, size)
    bad = (out < d.lo) | (out > d.hi)
    # resample the tails a few times, then clip the stragglers
    for _ in range(8):
        if not bad.any():
            break
        out[bad] = rng.normal(d.mean, d.std, int(bad.sum()))
        bad = (out < d.lo) | (out > d.hi)
    return np.clip(out, d.lo, d.hi)


def snap(x: np.ndarray, quanta) -> np.ndarray:
    """Snap each value to the nearest allocation quantum."""
    q = np.asarray(quanta)
    return q[np.argmin(np.abs(x[:, None] - q[None, :]), axis=1)]


def sample_class(rng: np.random.Generator, dists: ClassDists, n: int,
                 gpu_quanta=(0.0, 1.0, 2.0, 4.0, 8.0)):
    exec_min = np.maximum(sample_trunc_normal(rng, dists.exec_min, n), 1.0)
    cpu = np.round(sample_trunc_normal(rng, dists.cpu, n))
    # whole GBs: keeps resource arithmetic exact in float32
    ram = np.round(sample_trunc_normal(rng, dists.ram, n))
    gpu = snap(sample_trunc_normal(rng, dists.gpu, n), gpu_quanta)
    demand = np.stack([np.maximum(cpu, 1.0), np.maximum(ram, 1.0),
                       np.maximum(gpu, 0.0)], axis=1)
    return np.round(exec_min).astype(np.int64), demand


def generate(cfg: SimConfig, seed: int = None) -> JobSet:
    """Paper-synthetic job set: truncated-normal classes, closed-loop
    admission at the FIFO-normalized ``cfg.workload.load``."""
    wl = cfg.workload
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    n = wl.n_jobs
    is_te = rng.random(n) < wl.te_fraction

    exec_total = np.zeros(n, np.int64)
    demand = np.zeros((n, 3))
    n_te = int(is_te.sum())
    exec_total[is_te], demand[is_te] = sample_class(
        rng, wl.te, n_te, wl.gpu_quanta)
    exec_total[~is_te], demand[~is_te] = sample_class(
        rng, wl.be, n - n_te, wl.gpu_quanta)

    gp = np.round(sample_trunc_normal(rng, wl.scaled_gp(), n)).astype(np.int64)

    # single-node jobs only (SimConfig refuses multi_node_frac > 0), so
    # no gang widths are drawn and the rng stream matches the reference
    n_nodes = np.ones(n, np.int64)

    node_cap = np.asarray(cfg.cluster.node.as_tuple())
    js = JobSet(submit=np.zeros(n, np.int64), exec_total=exec_total,
                demand=demand, is_te=is_te, gp=gp, n_nodes=n_nodes)
    js.submit = closed_loop_submit_times(cfg, js)
    js.validate(node_cap)
    return js


def closed_loop_submit_times(cfg: SimConfig, js: JobSet) -> np.ndarray:
    """Paper §4.2: jobs are submitted "at such a rate that the cluster
    load ... would be kept at 2.0 if they were scheduled by FIFO" —
    realized as a closed-loop FIFO run that admits the next job
    whenever the backlog drops below ``load``; the admit ticks become
    the open-loop submit times used by every policy."""
    fifo_cfg = dataclasses.replace(cfg, policy="fifo")
    admit = FifoAdmission(fifo_cfg, js, cfg.workload.load).run()
    bad = np.flatnonzero(admit < 0)
    if bad.size:
        raise ValueError(
            f"closed-loop admission left job {int(bad[0])} with a "
            f"negative admit time ({bad.size} of {js.n} jobs "
            "unadmitted) — FIFO admission run ended early")
    return admit.copy()

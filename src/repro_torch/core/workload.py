"""Synthetic workload generation (paper §4.2), the §4.4 trace proxy
and the chunked synthetic stream, host numpy.

The port's copy of the JAX package's generators: the same samplers
drawing from the same ``numpy`` generators in the same order, so every
array (gang widths and closed-loop submit times included) is
bit-identical to ``repro.core.workload``'s for the same config.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.cluster import (ClassDists, SimConfig, TruncNormal,
                                         WorkloadSpec)
from repro_torch.core.simulator import Simulator
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


def sample_gang_widths(rng: np.random.Generator, wl: WorkloadSpec,
                       n: int) -> np.ndarray:
    """Gang widths for ``n`` jobs; the one sampler every generator uses
    (the rng stream is untouched when ``multi_node_frac == 0``)."""
    n_nodes = np.ones(n, np.int64)
    if wl.multi_node_frac > 0:
        gang = rng.random(n) < wl.multi_node_frac
        n_nodes[gang] = rng.choice(wl.multi_node_widths, int(gang.sum()))
    return n_nodes


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


def cluster_fraction(demand: np.ndarray, cluster_cap: np.ndarray
                     ) -> np.ndarray:
    """Mean of the three cluster-normalized resources (the load norm)."""
    return (demand / cluster_cap[None, :]).mean(axis=1)


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

    n_nodes = sample_gang_widths(rng, wl, n)

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
    the open-loop submit times used by every policy. The FIFO run is
    the reference :class:`Simulator` with the config's backfill switch,
    as in the JAX package."""
    fifo_cfg = dataclasses.replace(cfg, policy="fifo")
    sim = Simulator(fifo_cfg, js, admission_target=cfg.workload.load)
    sim.run()
    admit = sim.admit_time
    bad = np.flatnonzero(admit < 0)
    if bad.size:
        raise ValueError(
            f"closed-loop admission left job {int(bad[0])} with a "
            f"negative admit time ({bad.size} of {js.n} jobs "
            "unadmitted) — FIFO admission run ended early")
    return admit.copy()


def generate_trace_proxy(cfg: SimConfig, seed: int = None) -> JobSet:
    """Heavy-tailed proxy for the paper's private trace (§4.4):
    log-normal execution times (median TE 4', BE 20', long tails to the
    truncation caps) and bursty arrivals (exponential gaps modulated by
    a slow on/off cycle)."""
    wl = cfg.workload
    rng = np.random.default_rng((cfg.seed if seed is None else seed) + 7919)
    n = wl.n_jobs
    is_te = rng.random(n) < wl.te_fraction

    def lognorm(median, sigma, lo, hi, size):
        x = np.exp(np.log(median) + sigma * rng.standard_normal(size))
        return np.clip(x, lo, hi)

    exec_total = np.where(
        is_te,
        lognorm(4.0, 1.0, 1.0, wl.te.exec_min.hi, n),
        lognorm(20.0, 1.6, 3.0, wl.be.exec_min.hi, n)).astype(np.int64)
    exec_total = np.maximum(exec_total, 1)

    demand = np.zeros((n, 3))
    n_te = int(is_te.sum())
    _, demand[is_te] = sample_class(rng, wl.te, n_te, wl.gpu_quanta)
    _, demand[~is_te] = sample_class(rng, wl.be, n - n_te, wl.gpu_quanta)

    gp = np.round(sample_trunc_normal(rng, wl.scaled_gp(), n)).astype(np.int64)
    n_nodes = sample_gang_widths(rng, wl, n)

    node_cap = np.asarray(cfg.cluster.node.as_tuple())
    cluster_cap = node_cap * cfg.cluster.n_nodes
    work = exec_total * cluster_fraction(demand, cluster_cap) * n_nodes
    lam = wl.load / work.mean()
    # bursty arrivals: rate doubles during "day", halves during "night"
    gaps = rng.exponential(1.0 / lam, n)
    phase = np.sin(np.arange(n) / 2048.0 * 2 * np.pi)
    gaps = gaps * np.where(phase > 0, 0.5, 2.0)
    submit = np.floor(np.cumsum(gaps)).astype(np.int64)

    js = JobSet(submit=submit, exec_total=exec_total, demand=demand,
                is_te=is_te, gp=gp, n_nodes=n_nodes)
    js.validate(node_cap)
    return js


def stream_rate(cfg: SimConfig, seed: int = None,
                probe_n: int = 2048) -> float:
    """Open-loop arrival rate (jobs / minute) of the chunked stream:
    ``wl.load`` over the expected per-job work, estimated from a
    fixed-size probe drawn from its own rng stream (independent of the
    job count and the chunk size)."""
    wl = cfg.workload
    rng = np.random.default_rng(((cfg.seed if seed is None else seed),
                                 0xA11))
    is_te = rng.random(probe_n) < wl.te_fraction
    n_te = int(is_te.sum())
    exec_total = np.zeros(probe_n, np.int64)
    demand = np.zeros((probe_n, 3))
    exec_total[is_te], demand[is_te] = sample_class(
        rng, wl.te, n_te, wl.gpu_quanta)
    exec_total[~is_te], demand[~is_te] = sample_class(
        rng, wl.be, probe_n - n_te, wl.gpu_quanta)
    n_nodes = sample_gang_widths(rng, wl, probe_n)
    cluster_cap = (np.asarray(cfg.cluster.node.as_tuple())
                   * cfg.cluster.n_nodes)
    work = exec_total * cluster_fraction(demand, cluster_cap) * n_nodes
    return wl.load / float(work.mean())


def stream_chunks(cfg: SimConfig, n_jobs: int = None, chunk: int = 1024,
                  seed: int = None):
    """Chunked, seeded synthetic job stream: yields submit-sorted
    ``JobSet`` chunks totalling ``n_jobs`` jobs. Chunk ``k`` is drawn
    entirely from ``default_rng((seed, k))`` and the arrival clock is
    the only state carried between chunks, so their concatenation is
    the stream's monolithic equivalent. Arrivals are open-loop
    (exponential gaps at the :func:`stream_rate` rate)."""
    wl = cfg.workload
    seed = cfg.seed if seed is None else seed
    n_total = int(wl.n_jobs if n_jobs is None else n_jobs)
    lam = stream_rate(cfg, seed)
    clock = 0.0
    start, k = 0, 0
    while start < n_total:
        n = min(int(chunk), n_total - start)
        rng = np.random.default_rng((seed, k))
        is_te = rng.random(n) < wl.te_fraction
        n_te = int(is_te.sum())
        exec_total = np.zeros(n, np.int64)
        demand = np.zeros((n, 3))
        exec_total[is_te], demand[is_te] = sample_class(
            rng, wl.te, n_te, wl.gpu_quanta)
        exec_total[~is_te], demand[~is_te] = sample_class(
            rng, wl.be, n - n_te, wl.gpu_quanta)
        gp = np.round(sample_trunc_normal(
            rng, wl.scaled_gp(), n)).astype(np.int64)
        n_nodes = sample_gang_widths(rng, wl, n)
        at = clock + np.cumsum(rng.exponential(1.0 / lam, n))
        clock = float(at[-1])
        yield JobSet(submit=np.floor(at).astype(np.int64),
                     exec_total=exec_total, demand=demand,
                     is_te=is_te, gp=gp, n_nodes=n_nodes)
        start += n
        k += 1


def sparse_long_horizon(n: int = 512, seed: int = 0,
                        gap_mean: float = 180.0) -> JobSet:
    """Trickle arrivals (exponential gaps, mean ``gap_mean`` minutes)
    with heavy-tailed executions: the regime where a tick-by-tick loop
    wastes almost every iteration."""
    rng = np.random.default_rng(seed)
    submit = np.cumsum(rng.exponential(gap_mean, n).astype(np.int64))
    is_te = rng.random(n) < 0.3
    exec_total = np.maximum(
        rng.lognormal(np.log(60), 1.2, n).astype(np.int64), 1)
    exec_total = np.minimum(exec_total, 1440)
    exec_total[is_te] = np.minimum(exec_total[is_te], 30)
    demand = np.stack([
        np.clip(np.round(rng.normal(8, 6, n)), 1, 32),
        np.clip(np.round(rng.normal(48, 48, n)), 1, 256),
        rng.choice([0.0, 1.0, 2.0, 4.0, 8.0], n)], axis=1)
    gp = np.round(np.clip(rng.normal(3, 3, n), 0, 20)).astype(np.int64)
    return JobSet(submit=submit, exec_total=exec_total, demand=demand,
                  is_te=is_te, gp=gp)

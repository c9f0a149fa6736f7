"""Closed-loop FIFO admission run (paper §4.2), host numpy, float64.

The lean FIFO-only counterpart of the reference simulator's admission
path: ``admission_fraction`` and ``AdmissionGate`` as they are, and a
FIFO run whose arrivals, head-of-line first-fit schedule pass,
finishes and event fast-forward follow the reference's step order
exactly, so the recorded admit times are bit-identical to the JAX
package's ``closed_loop_submit_times``. Under FIFO every job enters one
lane in admission order and nothing is ever requeued, so the lane is a
plain deque.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.core.engine.placement import ClusterState
from repro_torch.core.types import JobSet


def admission_fraction(demand: np.ndarray, n_nodes: np.ndarray,
                       node_cap: np.ndarray,
                       cluster_nodes: int) -> np.ndarray:
    """Per-job FIFO-normalized load fraction: the mean of the three
    cluster-normalized resources times the gang width."""
    cluster_cap = node_cap * cluster_nodes
    return (demand / cluster_cap[None, :]).mean(axis=1) * n_nodes


class AdmissionGate:
    """Closed-loop admission state: a scalar backlog accumulator over
    :func:`admission_fraction` values. Admits happen in job-index
    order and releases in finish-tick-then-index order, which fixes the
    float accumulation and so every ``wants_next`` decision."""

    def __init__(self, target: float):
        self.target = float(target)
        self.load = 0.0

    def wants_next(self) -> bool:
        """Is the backlog below target, i.e. is an admission due?"""
        return self.load < self.target

    def admit(self, frac) -> None:
        self.load += frac

    def release(self, frac) -> None:
        self.load -= frac


class FifoAdmission:
    """FIFO run that admits the next job (in index order) whenever the
    backlog load is below ``target``; ``run`` returns the admit ticks."""

    def __init__(self, cfg, jobs: JobSet, target: float):
        if target <= 0:
            raise ValueError(f"admission target must be > 0, got {target}")
        self.jobs = jobs
        self.gate = AdmissionGate(target)
        node_cap = np.asarray(cfg.cluster.node.as_tuple(), np.float64)
        self.cluster = ClusterState(cfg.cluster.n_nodes, node_cap)
        self.demand = np.asarray(jobs.demand, np.float64)
        self.width = np.asarray(jobs.n_nodes, np.int64)
        self.frac = admission_fraction(jobs.demand, jobs.n_nodes,
                                       node_cap, cfg.cluster.n_nodes)
        self.remaining = jobs.exec_total.astype(np.int64).copy()
        self.admit_time = np.full(jobs.n, -1, np.int64)
        self.queue: deque = deque()
        self.running: set = set()
        self.job_nodes: dict = {}
        self.n_done = 0
        self._next = 0

    def _head_fits(self):
        if not self.queue:
            return None
        j = self.queue[0]
        return self.cluster.fits_job(self.demand[j], int(self.width[j]))

    def step(self, t: int) -> None:
        n = self.jobs.n
        while self._next < n and self.gate.wants_next():
            j = self._next
            self.queue.append(j)
            self.admit_time[j] = t
            self.gate.admit(self.frac[j])
            self._next += 1
        # head-of-line FIFO schedule pass
        while True:
            nodes = self._head_fits()
            if nodes is None:
                break
            j = self.queue.popleft()
            self.job_nodes[j] = nodes
            self.cluster.alloc(nodes, self.demand[j])
            self.running.add(j)
        # run for one minute
        if self.running:
            run = np.fromiter(self.running, np.int64, count=len(self.running))
            self.remaining[run] -= 1
            for j in np.sort(run[self.remaining[run] <= 0]):
                j = int(j)
                self.cluster.release(self.job_nodes.pop(j), self.demand[j])
                self.running.discard(j)
                self.n_done += 1
                self.gate.release(self.frac[j])

    def _fast_forward(self, t: int, max_ticks: int) -> int:
        """The next tick that must execute; bulk-applies the countdowns
        of the skipped (provably no-op) ticks."""
        if self._head_fits() is not None:
            return t
        if self._next < self.jobs.n and self.gate.wants_next():
            return t                          # admission due next tick
        if not self.running:
            raise RuntimeError(
                "admission run stalled: jobs remain but nothing runs and "
                "nothing can be admitted or scheduled")
        run = np.fromiter(self.running, np.int64, count=len(self.running))
        nxt = t - 1 + int(self.remaining[run].min())
        if nxt <= t:
            return t
        if nxt >= max_ticks:
            raise RuntimeError(
                f"admission run did not converge in {max_ticks} ticks")
        self.remaining[run] -= nxt - t
        return nxt

    def run(self, max_ticks: int = 10_000_000) -> np.ndarray:
        t = 0
        n = self.jobs.n
        while self.n_done < n:
            self.step(t)
            t += 1
            if self.n_done < n:
                if t >= max_ticks:
                    raise RuntimeError(
                        f"admission run did not converge in {t} ticks")
                t = self._fast_forward(t, max_ticks)
        return self.admit_time

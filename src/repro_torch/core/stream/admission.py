"""Streaming closed-loop admission (paper §4.2): the port of the JAX
package's ``core/stream/admission.py``, host numpy only.

The paper's headline experiments submit jobs "at such a rate that the
cluster load ... would be kept at 2.0 if they were scheduled by FIFO".
Monolithically that is ``workload.closed_loop_submit_times``: a full
FIFO simulation over the whole jobset whose admit ticks become every
policy's open-loop submit times. This module is the same arrival
process as a *source transformer*: :class:`ClosedLoopAdmission` wraps
any job stream (the input submit times are ignored — the stream is an
arrival ORDER plus job data), runs an incremental FIFO backlog
simulation over a recycled slot pool, and yields submit-sorted chunks
whose ``submit`` fields are the closed-loop admit ticks. Memory is
O(live FIFO backlog + chunk), which the closed loop itself bounds —
independent of the stream length — so the load-2.0 regime streams at
10^5-10^6 jobs.

Bit-exactness contract (the reason this file mirrors
``core/simulator.py`` so closely): the admit ticks must equal the
monolithic ``closed_loop_submit_times`` output EXACTLY on any
materializable stream. That pins down

  * the load fractions (:func:`repro_torch.core.simulator.admission_fraction`
    — row-wise, so chunked evaluation is bitwise equal to whole-array
    evaluation) and the :class:`AdmissionGate` float accumulator the
    two drivers share;
  * the per-tick phase order (admit -> expire_grace -> schedule ->
    run-minute -> tick_clocks), copied from ``Simulator.step``;
  * finish processing in GLOBAL arrival order: the monolithic sim
    finishes jobs in sorted job-index order, so the pool driver sorts
    finishing slots by their global id before calling ``finish`` —
    both the gate's float subtraction order and the cluster free-vector
    accumulation order depend on it;
  * the event-mode fast-forward rule, copied from
    ``Simulator._fast_forward`` (admission due / next finish / next
    grace expiry).

FIFO is non-preemptive (no TE lane, no grace, no rng draws), which is
what makes the slot recycling safe and the mirror small; backfill
(``cfg.backfill``) carries over exactly as it does monolithically,
because both drivers delegate the schedule pass to the same
:class:`SchedulerCore`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.configs.cluster import SimConfig
from repro_torch.core import policy_registry
from repro_torch.core.engine import ClusterState, SchedulerCore
from repro_torch.core.simulator import AdmissionGate, admission_fraction
from repro_torch.core.stream.source import JobSource
from repro_torch.core.types import NOT_ARRIVED, JobSet

_INITIAL_POOL = 256


class ClosedLoopAdmission:
    """Iterable of submit-sorted JobSet chunks whose submit times are
    closed-loop admit ticks (module docstring).

    ``source``: the inner job stream (any ``JobSource`` or chunk
    iterator); its submit times are IGNORED — jobs are admitted in
    stream order. ``target`` is the FIFO-normalized backlog target
    (default ``cfg.workload.load``); ``chunk`` the pending-buffer /
    output chunk size. Iterating runs the embedded FIFO simulation
    lazily; ``n_admitted`` / ``max_live`` / ``pool_capacity`` report
    progress and the realized backlog bound afterwards.
    """

    def __init__(self, cfg: SimConfig, source, target: float = None,
                 chunk: int = 1024, max_ticks: int = 10_000_000):
        # same FIFO re-pointing as workload.closed_loop_submit_times:
        # only the policy changes, so cfg.backfill etc. carry over
        self.cfg = dataclasses.replace(cfg, policy="fifo")
        self.target = float(cfg.workload.load if target is None
                            else target)
        if self.target <= 0:
            raise ValueError(
                f"closed-loop admission needs a positive load target, "
                f"got {self.target}")
        self.source = (source if isinstance(source, JobSource)
                       else JobSource(source))
        self.chunk = int(chunk)
        self.max_ticks = int(max_ticks)
        self.n_admitted = 0
        self.max_live = 0
        self.pool_capacity = 0

    # -- recycled slot pool -------------------------------------------

    def _grow(self, core: SchedulerCore) -> None:
        """Double the slot pool (driver arrays + core arrays together);
        freed capacity is pushed onto the free stack."""
        old = core.state.size
        new = max(_INITIAL_POOL, old * 2)
        core.grow_to(new)
        k = new - old
        self._gp = np.concatenate([self._gp, np.zeros(k, np.int64)])
        self._remaining = np.concatenate(
            [self._remaining, np.zeros(k, np.int64)])
        self._frac = np.concatenate([self._frac, np.zeros(k)])
        self._gid = np.concatenate([self._gid, np.full(k, -1, np.int64)])
        self._free.extend(range(old, new))
        self.pool_capacity = new

    def _admit(self, core: SchedulerCore, js: JobSet, i: int,
               frac: np.ndarray) -> None:
        """Recycle (or grow) a slot for stream job ``i`` of the pending
        chunk and enqueue it."""
        if not self._free:
            self._grow(core)
        s = self._free.pop()
        core.demand[s] = js.demand[i]
        core.is_te[s] = bool(js.is_te[i])
        core.width[s] = int(js.n_nodes[i])
        core.state[s] = NOT_ARRIVED
        core.node[s] = -1
        core.preempt_count[s] = 0
        core.grace_left[s] = 0
        core.victim_of[s] = -1
        core.te_pending[s] = 0
        self._gp[s] = int(js.gp[i])
        self._remaining[s] = int(js.exec_total[i])
        self._frac[s] = frac[i]
        self._gid[s] = self.n_admitted
        core.enqueue(s)
        self.n_admitted += 1
        live = core.state.size - len(self._free)
        if live > self.max_live:
            self.max_live = live

    # -- the embedded FIFO simulation ---------------------------------

    def _fast_forward(self, core: SchedulerCore, gate: AdmissionGate,
                      t: int) -> int:
        """``Simulator._fast_forward`` for the pool driver: un-admitted
        jobs always exist at the call site, so the admission-due check
        reduces to the gate."""
        if core.schedule_would_act():
            return t
        if gate.wants_next():
            return t                          # admission due next tick
        nxt = None
        run = None
        if core.running:
            run = np.fromiter(core.running, np.int64,
                              count=len(core.running))
            nxt = t - 1 + int(self._remaining[run].min())
        g = core.min_grace_left()
        if g is not None:
            ev = t + g
            nxt = ev if nxt is None else min(nxt, ev)
        if nxt is None:
            raise RuntimeError(
                "closed-loop admission stalled: backlog at target but "
                "nothing is running or in grace — a queued job cannot "
                "fit the cluster at all")
        if nxt <= t:
            return t
        if nxt >= self.max_ticks:
            raise RuntimeError(
                f"closed-loop admission did not converge in "
                f"{self.max_ticks} ticks")
        k = nxt - t
        if run is not None:
            self._remaining[run] -= k
        core.tick_clocks(k)
        return nxt

    def __iter__(self) -> Iterator[JobSet]:
        cfg = self.cfg
        node_cap = np.asarray(cfg.cluster.node.as_tuple(), np.float64)
        n_nodes = cfg.cluster.n_nodes
        gate = AdmissionGate(self.target)
        core = SchedulerCore(
            cluster=ClusterState(n_nodes, node_cap),
            policy=policy_registry.make(cfg.policy, s=cfg.s),
            max_preemptions=cfg.max_preemptions,
            rng=np.random.default_rng(cfg.seed + 104729),
            gp_of=lambda ids: self._gp[ids],
            remaining_of=lambda ids: self._remaining[ids],
            backfill=cfg.backfill,
            backfill_depth=cfg.backfill_depth,
        )
        self._gp = np.zeros(0, np.int64)
        self._remaining = np.zeros(0, np.int64)
        self._frac = np.zeros(0)
        self._gid = np.zeros(0, np.int64)
        self._free: List[int] = []
        self._grow(core)

        t = 0
        pending: Optional[JobSet] = None
        pi = 0
        pfrac = padmit = None
        while True:
            if pending is None or pi == pending.n:
                if pending is not None:
                    yield JobSet(submit=padmit,
                                 exec_total=pending.exec_total,
                                 demand=pending.demand,
                                 is_te=pending.is_te, gp=pending.gp,
                                 n_nodes=pending.n_nodes)
                pending = self.source.take(self.chunk)
                if pending is None:
                    return                    # every job admitted
                pi = 0
                pfrac = admission_fraction(
                    np.asarray(pending.demand, np.float64),
                    pending.n_nodes, node_cap, n_nodes)
                padmit = np.zeros(pending.n, np.int64)
            # one Simulator.step, phase for phase ----------------------
            while pi < pending.n and gate.wants_next():
                self._admit(core, pending, pi, pfrac)
                gate.admit(pfrac[pi])
                padmit[pi] = t
                pi += 1
            if pi == pending.n:
                continue       # refill and keep admitting at this tick
            core.expire_grace(t)               # FIFO: structural no-op
            core.schedule(t)
            if core.running:
                run = np.fromiter(core.running, np.int64,
                                  count=len(core.running))
                self._remaining[run] -= 1
                fin = run[self._remaining[run] <= 0]
                # finish in GLOBAL arrival order — the monolithic sim
                # finishes by sorted job index, and both the gate and
                # the cluster free vector accumulate in that order
                for s in fin[np.argsort(self._gid[fin])]:
                    s = int(s)
                    core.finish(s, t + 1)
                    gate.release(self._frac[s])
                    self._free.append(s)
            core.tick_clocks()
            t += 1
            if t >= self.max_ticks:
                raise RuntimeError(
                    f"closed-loop admission did not converge in "
                    f"{self.max_ticks} ticks")
            t = self._fast_forward(core, gate, t)


def closed_loop_source(cfg: SimConfig, n_jobs: int = None,
                       chunk: int = 1024, seed: int = None) -> JobSource:
    """The paper-synthetic workload with streamed closed-loop arrivals:
    ``workload.stream_chunks`` job data (its open-loop submit times
    discarded) re-stamped with admit ticks holding the FIFO-normalized
    backlog at ``cfg.workload.load``. The streamed twin of
    ``workload.generate``'s arrival process, O(chunk + backlog) memory.
    """
    from repro_torch.core import workload
    inner = JobSource(workload.stream_chunks(cfg, n_jobs, chunk=chunk,
                                             seed=seed))
    return JobSource(ClosedLoopAdmission(cfg, inner, chunk=chunk))


def verify_admission_parity(cfg: SimConfig, n_jobs: int = 400,
                            chunk: int = 64) -> List[str]:
    """The admission bit-exactness contract, executable: stream a
    synthetic prefix through :class:`ClosedLoopAdmission` AND compute
    the monolithic ``closed_loop_submit_times`` on the materialized
    job data; return the names of any fields that differ (empty list
    == bit-exact). Job data must pass through unchanged; admit times
    must match the monolithic FIFO simulation exactly."""
    from repro_torch.core import workload
    from repro_torch.core.stream.source import materialize
    streamed = materialize(JobSource(ClosedLoopAdmission(
        cfg, JobSource(workload.stream_chunks(cfg, n_jobs, chunk=chunk)),
        chunk=chunk)))
    data = materialize(JobSource(
        workload.stream_chunks(cfg, n_jobs, chunk=chunk)))
    expect = workload.closed_loop_submit_times(cfg, data)
    diff = [f for f in ("exec_total", "demand", "is_te", "gp", "n_nodes")
            if not np.array_equal(getattr(streamed, f),
                                  getattr(data, f))]
    if not np.array_equal(streamed.submit, expect):
        diff.append("admit_time")
    return diff

"""Reference discrete-time cluster simulator (paper §4.1 semantics),
host numpy, float64: the port's numpy reference engine.

The port's copy of the JAX package's ``core/simulator.py``: a faithful,
transparent implementation of the paper's mechanics, and the parity
oracle of the torch engine (``core/sim_torch.py``). It never touches a
GPU.

Mechanics:
  * 1-minute ticks; allocation decided every tick.
  * Strict FIFO for the BE queue (head-of-line blocking), or bounded
    first-fit backfill with ``SimConfig.backfill``.
  * TE jobs: under preemptive policies they live in a TE-priority FIFO
    served before the BE queue; under vanilla FIFO they share the queue.
  * Preemption: victims get a grace period (GP); resources free when the
    GP expires (GP=0 vacates the same tick); the victim re-enters the
    TOP of the BE queue with its remaining execution time intact.
  * A TE that triggered preemption re-triggers victim selection only
    after all victims it signalled have vacated.

:class:`Simulator` is a thin loop over the shared scheduling core
(``core/engine``): the :class:`SchedulerCore` owns the queues,
placement, the grace lifecycle and policy invocation; the simulator owns
the workload (arrivals / closed-loop admission), the clock and result
assembly. The default ``mode="event"`` jumps the clock straight to the
next event (arrival, finish, grace expiry) whenever a schedule pass
provably cannot start or preempt anything; the skipped ticks are pure
countdowns, bulk-applied, so the result is bit-for-bit identical to
``mode="tick"``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.configs.cluster import SimConfig
from repro_torch.core import policy_registry
from repro_torch.core.engine import ClusterState, CoreHooks, SchedulerCore
from repro_torch.core.types import JobSet, PreemptionEvent, SimResult
from repro_torch.obs import schema as obs_schema


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

    @property
    def active(self) -> bool:
        return self.target > 0

    def wants_next(self) -> bool:
        """Is the backlog below target, i.e. is an admission due?"""
        return self.load < self.target

    def admit(self, frac) -> None:
        self.load += frac

    def release(self, frac) -> None:
        self.load -= frac


class Simulator:
    def __init__(self, cfg: SimConfig, jobs: JobSet,
                 admission_target: float = 0.0, trace: bool = False):
        """``admission_target`` > 0 switches to closed-loop admission:
        ``jobs.submit`` is ignored and the next job (in index order) is
        admitted whenever the backlog load (cluster-normalized demand of
        all admitted, unfinished jobs) is below the target. Used once,
        under FIFO, to realize the paper's "load kept at 2.0 if scheduled
        by FIFO" arrival process; the recorded admit times then serve as
        open-loop submit times for every policy.

        ``trace`` records the canonical event stream (``obs.schema``)
        into ``SimResult.trace`` — the reference half of the
        cross-engine trace-parity contract."""
        self.cfg = cfg
        self.jobs = jobs
        self.admission_target = admission_target
        self.gate = AdmissionGate(admission_target)
        self.trace_events = [] if trace else None
        self.admit_time = np.full(jobs.n, -1, np.int64)
        self.policy = policy_registry.make(cfg.policy, s=cfg.s)
        self.node_cap = np.asarray(cfg.cluster.node.as_tuple(), np.float64)
        self.n_nodes = cfg.cluster.n_nodes
        self.rng = np.random.default_rng(cfg.seed + 104729)

        n = jobs.n
        self.remaining = jobs.exec_total.astype(np.int64).copy()
        self.finish = np.full(n, -1, np.int64)
        self.vacated_at = np.full(n, -1, np.int64)
        self.events: List[PreemptionEvent] = []
        self.open_events: Dict[int, PreemptionEvent] = {}

        self.core = SchedulerCore(
            cluster=ClusterState(self.n_nodes, self.node_cap),
            policy=self.policy,
            max_preemptions=cfg.max_preemptions,
            rng=self.rng,
            demand=jobs.demand,
            is_te=jobs.is_te,
            width=jobs.n_nodes,
            gp_of=lambda ids: jobs.gp[ids],
            remaining_of=lambda ids: self.remaining[ids],
            backfill=cfg.backfill,
            backfill_depth=cfg.backfill_depth,
            hooks=CoreHooks(on_start=self._on_start,
                            on_signal=self._on_signal,
                            on_vacate=self._on_vacate,
                            on_finish=self._on_finish,
                            on_backfill=self._on_backfill),
        )

        order = np.argsort(jobs.submit, kind="stable")
        self.arrival_order = order
        self._next_arrival = 0
        self.frac = admission_fraction(jobs.demand, jobs.n_nodes,
                                       self.node_cap, self.n_nodes)

    # -- result bookkeeping (simulator-side, via core hooks) -----------------

    def _emit(self, t: int, code: int, j: int, aux: int = -1,
              nodes=()) -> None:
        if self.trace_events is not None:
            self.trace_events.append(obs_schema.Event(
                t=int(t), code=code, job=int(j), aux=int(aux),
                nodes=tuple(int(n) for n in nodes)))

    def _on_start(self, j: int, nodes: np.ndarray, t: int) -> None:
        resumed = self.vacated_at[j] >= 0
        self._emit(t, obs_schema.RESUME if resumed else obs_schema.START,
                   j, nodes=np.atleast_1d(np.asarray(nodes)))
        if resumed:
            ev = self.open_events.pop(j, None)
            if ev is not None:
                ev.resume_time = t
            self.vacated_at[j] = -1

    def _on_signal(self, j: int, te: int, t: int) -> None:
        self._emit(t, obs_schema.PREEMPT_SIGNAL, j, aux=te)
        ev = PreemptionEvent(job=j, te_job=te, signal_time=t)
        self.events.append(ev)
        self.open_events[j] = ev

    def _on_vacate(self, j: int, t: int) -> None:
        if self.trace_events is not None:
            # a GP=0 victim vacates inline at signal time without ever
            # entering grace — no GRACE_EXPIRE row for it
            if int(self.jobs.gp[j]) > 0:
                self._emit(t, obs_schema.GRACE_EXPIRE, j)
            ev = self.open_events.get(j)
            self._emit(t, obs_schema.VACATE, j,
                       aux=ev.te_job if ev is not None else -1)
            self._emit(t, obs_schema.REQUEUE, j)
        self.vacated_at[j] = t
        if j in self.open_events:
            self.open_events[j].vacate_time = t

    def _on_finish(self, j: int, t: int) -> None:
        self._emit(t, obs_schema.FINISH, j)

    def _on_backfill(self, j: int, skipped: int, t: int) -> None:
        self._emit(t, obs_schema.BACKFILL, j, aux=skipped)

    # -- state views (tests and subclasses introspect these) ----------------

    @property
    def free(self) -> np.ndarray:
        return self.core.cluster.free

    @property
    def pending_free(self) -> np.ndarray:
        return self.core.cluster.pending_free

    @property
    def state(self) -> np.ndarray:
        return self.core.state

    @property
    def node(self) -> np.ndarray:
        return self.core.node

    @property
    def preempt_count(self) -> np.ndarray:
        return self.core.preempt_count

    @property
    def grace_left(self) -> np.ndarray:
        return self.core.grace_left

    @property
    def job_nodes(self) -> Dict[int, np.ndarray]:
        return self.core.job_nodes

    @property
    def running(self):
        return self.core.running

    @property
    def running_be(self):
        return self.core.running_be

    @property
    def grace(self):
        return self.core.grace

    @property
    def n_done(self) -> int:
        return self.core.n_done

    # -- one tick ------------------------------------------------------------

    def step(self, t: int) -> None:
        jobs = self.jobs
        core = self.core
        # arrivals
        if self.gate.active:
            # closed-loop: admit next jobs while backlog < target
            while (self._next_arrival < jobs.n and
                   self.gate.wants_next()):
                j = self._next_arrival
                core.enqueue(j)
                self._emit(t, obs_schema.SUBMIT, j)
                self.admit_time[j] = t
                self.gate.admit(self.frac[j])
                self._next_arrival += 1
        else:
            while (self._next_arrival < jobs.n and
                   jobs.submit[self.arrival_order[self._next_arrival]] <= t):
                j = int(self.arrival_order[self._next_arrival])
                core.enqueue(j)
                self._emit(t, obs_schema.SUBMIT, j)
                self._next_arrival += 1
        # grace countdown -> vacate, then allocate
        core.expire_grace(t)
        core.schedule(t)
        # run for one minute
        if core.running:
            run = np.fromiter(core.running, np.int64, count=len(core.running))
            self.remaining[run] -= 1
            for j in np.sort(run[self.remaining[run] <= 0]):
                j = int(j)
                core.finish(j, t + 1)
                self.finish[j] = t + 1
                self.gate.release(self.frac[j])
        core.tick_clocks()

    # -- event-driven time advancement ---------------------------------------

    def _fast_forward(self, t: int, max_ticks: int) -> int:
        """Return the next tick that must actually execute, bulk-applying
        the countdowns of the skipped (provably no-op) ticks."""
        core = self.core
        if core.schedule_would_act():
            return t
        nxt = None
        if self.gate.active:
            if (self._next_arrival < self.jobs.n and
                    self.gate.wants_next()):
                return t                      # admission due next tick
        elif self._next_arrival < self.jobs.n:
            nxt = int(self.jobs.submit[
                self.arrival_order[self._next_arrival]])
        run = None
        if core.running:
            run = np.fromiter(core.running, np.int64, count=len(core.running))
            # remaining r after a step -> the job finishes during the
            # step at tick (t - 1) + r
            ev = t - 1 + int(self.remaining[run].min())
            nxt = ev if nxt is None else min(nxt, ev)
        g = core.min_grace_left()
        if g is not None:
            # grace_left g after a step -> vacates at the top of tick t + g
            ev = t + g
            nxt = ev if nxt is None else min(nxt, ev)
        if nxt is None:
            raise RuntimeError(
                "simulation stalled: jobs remain but no arrival, finish or "
                "grace expiry is pending and nothing can be scheduled")
        if nxt <= t:
            return t
        if nxt >= max_ticks:
            raise RuntimeError(
                f"simulation did not converge in {max_ticks} ticks")
        k = nxt - t
        if run is not None:
            self.remaining[run] -= k
        core.tick_clocks(k)
        return nxt

    def run(self, max_ticks: int = 10_000_000,
            mode: str = "event") -> SimResult:
        """``mode="event"`` (default) and ``mode="tick"`` produce
        bit-identical results; event mode just skips no-op ticks."""
        if mode not in ("event", "tick"):
            raise ValueError(f"unknown advancement mode: {mode!r}")
        t = 0
        n = self.jobs.n
        while self.core.n_done < n:
            self.step(t)
            t += 1
            if self.core.n_done < n:
                if t >= max_ticks:
                    raise RuntimeError(
                        f"simulation did not converge in {t} ticks")
                if mode == "event":
                    t = self._fast_forward(t, max_ticks)
        return SimResult(
            finish=self.finish.copy(),
            exec_total=self.jobs.exec_total.copy(),
            submit=self.jobs.submit.copy(),
            is_te=self.jobs.is_te.copy(),
            preempt_count=self.core.preempt_count.copy(),
            events=self.events,
            makespan=t,
            trace=self.trace_events,
        )


def simulate(cfg: SimConfig, jobs: JobSet, mode: str = "event",
             trace: bool = False) -> SimResult:
    return Simulator(cfg, jobs, trace=trace).run(mode=mode)


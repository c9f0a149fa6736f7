"""The shared scheduling state machine: :class:`SchedulerCore`.

The port's copy of the JAX package's ``core/engine/core.py``, the
numpy reference engine's core. The paper's contribution (FitGpp,
Eq. 1-4) is a *decision rule*; the surrounding tick/queue/preemption
machinery is policy-independent and owned here:

  * queue lanes — TE priority FIFO + BE FIFO, lazy-deletion heaps,
    victims requeued on TOP (``engine/queues.py``);
  * placement — first-fit and gang (all-or-nothing) fitting with the
    shared ``FIT_EPS`` tolerance (``engine/placement.py``);
  * the grace-period preemption lifecycle — signal → grace countdown →
    vacate → requeue-on-top → resume — including the pending-free
    accounting that gates re-triggering;
  * the policy-invocation protocol — candidate marshalling, Eq. 2 best
    node per victim, under-P-cap-first ordering, gang selection
    (``engine/preemption.py``).

Callers own TIME and WORK: what a tick means (a simulated minute, or a
batch of real train steps for a live controller), when a job is done,
and how results are recorded (via :class:`CoreHooks`).
``core/simulator.py`` is a thin loop over this class.

Event-driven support: :meth:`schedule_would_act` reports whether a
schedule pass right now could start or preempt anything. When it
cannot, and no arrival/finish/grace-expiry is due, every intervening
tick is a pure countdown — callers may jump the clock and bulk-apply
the countdowns (:meth:`tick_clocks` with ``k > 1``) with bit-identical
semantics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set

import numpy as np

from repro_torch.core.engine import preemption as pre
from repro_torch.core.engine.placement import ClusterState
from repro_torch.core.engine.queues import QueueLanes
from repro_torch.core.types import (DONE, GRACE, NOT_ARRIVED, QUEUED,
                                    RUNNING, STATE_NAMES)

Hook = Callable[..., None]


@dataclass
class CoreHooks:
    """Caller callbacks, invoked AFTER the core state transition.

    on_start(j, nodes, t)      — job placed (fresh start or resume)
    on_signal(j, te, t)        — preemption signalled (grace begins)
    on_vacate(j, t)            — grace over, resources freed, requeued
    on_finish(j, t)            — job completed
    on_backfill(j, skipped, t) — job placed past ``skipped`` blocked
                                 jobs (fires after on_start, backfill
                                 passes only)
    """
    on_start: Optional[Hook] = None
    on_signal: Optional[Hook] = None
    on_vacate: Optional[Hook] = None
    on_finish: Optional[Hook] = None
    on_backfill: Optional[Hook] = None


class SchedulerCore:
    """Policy-independent scheduling state over integer job ids.

    Static job attributes (``demand``/``is_te``/``width``) are arrays,
    passed up front (simulator) or appended via :meth:`add_job` (a
    live controller). ``gp_of``/``remaining_of`` are accessors taking
    a scalar id or an id array — a live controller's grace periods are
    *live* quantities (sized from checkpoint state bytes), so they
    cannot be a static array.
    """

    def __init__(self, *, cluster: ClusterState, policy,
                 max_preemptions: int, rng: np.random.Generator,
                 gp_of: Callable, remaining_of: Callable,
                 demand: Optional[np.ndarray] = None,
                 is_te: Optional[np.ndarray] = None,
                 width: Optional[np.ndarray] = None,
                 backfill: bool = False, backfill_depth: int = 64,
                 hooks: Optional[CoreHooks] = None) -> None:
        self.cluster = cluster
        self.policy = policy
        self.max_preemptions = int(max_preemptions)
        self.rng = rng
        self.gp_of = gp_of
        self.remaining_of = remaining_of
        self.backfill = backfill
        self.backfill_depth = backfill_depth
        self.hooks = hooks or CoreHooks()

        self.demand = (np.zeros((0, cluster.node_cap.size))
                       if demand is None else np.asarray(demand, np.float64))
        n = self.demand.shape[0]
        self.is_te = (np.zeros(n, bool) if is_te is None
                      else np.asarray(is_te, bool))
        self.width = (np.ones(n, np.int64) if width is None
                      else np.asarray(width, np.int64))

        self.state = np.full(n, NOT_ARRIVED, np.int8)
        self.node = np.full(n, -1, np.int64)
        self.preempt_count = np.zeros(n, np.int64)
        self.grace_left = np.zeros(n, np.int64)
        self.victim_of = np.full(n, -1, np.int64)
        self.te_pending = np.zeros(n, np.int64)   # victims still in grace

        self.job_nodes: Dict[int, np.ndarray] = {}   # (gang) placements
        self.running: Set[int] = set()
        self.running_be: Set[int] = set()
        self.grace: Set[int] = set()
        self.n_done = 0
        self.lanes = QueueLanes(lambda j: self.state[j] == QUEUED)

    # -- dynamic workloads (live controllers, slot pools) -------------------

    def grow_to(self, n: int) -> None:
        """Grow every per-job array to at least ``n`` slots in one step
        (amortized O(1) per slot, vs :meth:`add_job`'s O(n) copy per
        call). Slot-pool loops recycle ids and grow by doubling; the
        new slots are inert — NOT_ARRIVED and never queued, invisible to
        scheduling until the caller initializes and enqueues them."""
        cur = self.state.size
        if n <= cur:
            return
        k = int(n) - cur

        def pad(arr, fill):
            ext = np.full((k,) + arr.shape[1:], fill, arr.dtype)
            return np.concatenate([arr, ext])

        self.demand = pad(self.demand, 0.0)
        self.is_te = pad(self.is_te, False)
        self.width = pad(self.width, 1)
        self.state = pad(self.state, NOT_ARRIVED)
        self.node = pad(self.node, -1)
        self.preempt_count = pad(self.preempt_count, 0)
        self.grace_left = pad(self.grace_left, 0)
        self.victim_of = pad(self.victim_of, -1)
        self.te_pending = pad(self.te_pending, 0)

    def add_job(self, demand, is_te: bool, width: int = 1) -> int:
        """Register one more job; returns its id."""
        j = self.demand.shape[0]
        self.demand = np.vstack([self.demand,
                                 np.asarray(demand, np.float64)[None, :]])
        self.is_te = np.append(self.is_te, bool(is_te))
        self.width = np.append(self.width, int(width))
        self.state = np.append(self.state, np.int8(NOT_ARRIVED))
        self.node = np.append(self.node, -1)
        self.preempt_count = np.append(self.preempt_count, 0)
        self.grace_left = np.append(self.grace_left, 0)
        self.victim_of = np.append(self.victim_of, -1)
        self.te_pending = np.append(self.te_pending, 0)
        return j

    # -- lifecycle -----------------------------------------------------------

    def _te_lane(self, j: int) -> bool:
        return self.policy.preemptive and bool(self.is_te[j])

    def enqueue(self, j: int) -> None:
        """Arrival: the job enters the tail of its lane."""
        self.state[j] = QUEUED
        self.lanes.push_back(int(j), self._te_lane(j))

    def fits_job(self, j: int) -> Optional[np.ndarray]:
        return self.cluster.fits_job(self.demand[j], int(self.width[j]))

    def start(self, j: int, nodes, t: int) -> None:
        nodes = np.atleast_1d(np.asarray(nodes))
        self.state[j] = RUNNING
        self.node[j] = int(nodes[0])
        self.job_nodes[j] = nodes
        self.cluster.alloc(nodes, self.demand[j])
        self.running.add(j)
        if not self.is_te[j]:
            self.running_be.add(j)
        if self.hooks.on_start:
            self.hooks.on_start(j, nodes, t)

    def signal_preemption(self, j: int, te: int, t: int) -> None:
        """Move a running BE job into its grace period (GP=0 vacates
        the same tick, matching the paper's immediate-kill limit)."""
        assert self.state[j] == RUNNING and not self.is_te[j], (
            f"victim {j} must be a running BE job, is "
            f"{STATE_NAMES[int(self.state[j])]}"
            f"{' (TE)' if self.is_te[j] else ''}")
        gp = int(self.gp_of(j))
        self.state[j] = GRACE
        self.grace_left[j] = gp
        self.preempt_count[j] += 1
        self.victim_of[j] = te
        self.te_pending[te] += 1
        self.running.discard(j)
        self.running_be.discard(j)
        self.cluster.promise(self.job_nodes[j], self.demand[j])
        if self.hooks.on_signal:
            self.hooks.on_signal(j, te, t)
        if gp <= 0:
            self.vacate(j, t)
        else:
            self.grace.add(j)

    def vacate(self, j: int, t: int) -> None:
        """Grace over: free the resources, requeue ON TOP of the lane."""
        nodes = self.job_nodes.pop(j)
        self.cluster.release(nodes, self.demand[j])
        self.cluster.unpromise(nodes, self.demand[j])
        self.node[j] = -1
        self.state[j] = QUEUED
        self.grace.discard(j)
        self.lanes.requeue_top(j, self._te_lane(j))
        te = int(self.victim_of[j])
        if te >= 0:
            self.te_pending[te] -= 1
            self.victim_of[j] = -1
        if self.hooks.on_vacate:
            self.hooks.on_vacate(j, t)

    def finish(self, j: int, t: int) -> None:
        nodes = self.job_nodes.pop(j)
        self.cluster.release(nodes, self.demand[j])
        self.node[j] = -1
        self.state[j] = DONE
        self.running.discard(j)
        self.running_be.discard(j)
        self.n_done += 1
        if self.hooks.on_finish:
            self.hooks.on_finish(j, t)

    def expire_grace(self, t: int) -> None:
        """Vacate every grace-expired job (job-index order: the torch
        engine's order)."""
        for j in sorted(j for j in self.grace if self.grace_left[j] <= 0):
            self.vacate(j, t)

    def tick_clocks(self, k: int = 1) -> None:
        """Count ``k`` minutes of grace down (end-of-tick; ``k > 1``
        only when the caller fast-forwards over no-op ticks)."""
        if self.grace:
            g = np.fromiter(self.grace, np.int64, count=len(self.grace))
            self.grace_left[g] -= k

    # -- victim selection ----------------------------------------------------

    def _be_candidates(self) -> np.ndarray:
        return np.sort(np.fromiter(self.running_be, np.int64,
                                   count=len(self.running_be)))

    def try_preempt_for(self, te: int, t: int) -> None:
        """Invoke the policy and signal its victims for TE job ``te``."""
        cand = self._be_candidates()
        if len(cand) == 0:
            return
        te_d = self.demand[te]
        cand_gp = np.asarray(self.gp_of(cand), np.float64)
        cand_rem = np.asarray(self.remaining_of(cand), np.float64)
        under = self.preempt_count[cand] < self.max_preemptions
        if int(self.width[te]) > 1:
            victims = pre.gang_select(
                policy=self.policy, rng=self.rng, te_demand=te_d,
                width=int(self.width[te]), free=self.cluster.free,
                cand_ids=cand,
                cand_nodes=[self.job_nodes[int(j)] for j in cand],
                cand_demand=self.demand[cand], cand_width=self.width[cand],
                cand_gp=cand_gp, cand_remaining=cand_rem, under_cap=under,
                node_cap=self.cluster.node_cap)
        else:
            cand_node = np.asarray([
                pre.best_victim_node(self.job_nodes[int(j)],
                                     self.cluster.free,
                                     self.demand[int(j)], te_d)
                for j in cand])
            victims = self.policy.select(
                rng=self.rng,
                te_demand=te_d,
                cand_ids=cand,
                cand_demand=self.demand[cand],
                cand_node_free=self.cluster.free[cand_node],
                cand_gp=cand_gp,
                cand_remaining=cand_rem,
                under_cap=under,
                all_run_demand=self.demand[cand],
                all_run_gp=cand_gp,
                node_cap=self.cluster.node_cap,
                free_by_node=self.cluster.free,
                cand_node=cand_node,
            )
        for v in victims:
            self.signal_preemption(int(v), te, t)

    def _should_trigger(self, j: int) -> bool:
        """Preempt only if the TE would not fit even counting resources
        already promised by in-flight grace periods ("the resource is
        insufficient", §2) — an imminent vacate is incoming supply, not
        a shortage — and no victim this TE already signalled is still
        in grace (defensive; rare)."""
        return (self.te_pending[j] == 0 and
                not self.cluster.fits_with_pending(self.demand[j],
                                                   int(self.width[j])))

    # -- the schedule pass ---------------------------------------------------

    def schedule(self, t: int) -> None:
        # 1) TE priority lane (preemptive policies only)
        if self.policy.preemptive:
            blocked: List[int] = []
            while True:
                j = self.lanes.pop(True)
                if j < 0:
                    break
                nodes = self.fits_job(j)
                if nodes is not None:
                    self.start(j, nodes, t)
                    continue
                if self._should_trigger(j):
                    self.try_preempt_for(j, t)
                    # GP=0 victims vacate inline: place the TE NOW,
                    # before the BE pass can reclaim the freed node.
                    nodes = self.fits_job(j)
                    if nodes is not None:
                        self.start(j, nodes, t)
                        continue
                blocked.append(j)
            for j in blocked:                # keep FIFO order among TE
                self.lanes.reinsert(j, True)
        # 2) BE queue (all jobs under vanilla FIFO): strict head-of-line,
        # or bounded first-fit backfill (beyond-paper, cfg.backfill)
        if not self.backfill:
            while True:
                head = self.lanes.peek(False)
                if head < 0:
                    break
                nodes = self.fits_job(head)
                if nodes is None:
                    break                     # head-of-line blocking
                self.lanes.pop(False)
                self.start(head, nodes, t)
        else:
            skipped: List[int] = []
            scanned = 0
            while scanned < self.backfill_depth:
                head = self.lanes.pop(False)
                if head < 0:
                    break
                nodes = self.fits_job(head)
                if nodes is not None:
                    self.start(head, nodes, t)
                    if scanned and self.hooks.on_backfill:
                        self.hooks.on_backfill(head, scanned, t)
                else:
                    skipped.append(head)
                    scanned += 1
            for j in skipped:                 # keep original keys
                self.lanes.reinsert(j, False)

    # -- event-driven support ------------------------------------------------

    def schedule_would_act(self) -> bool:
        """Could a schedule pass RIGHT NOW start or preempt anything?

        False means the next tick's schedule is a provable no-op (free
        and the queues cannot change before the next arrival / finish /
        grace-expiry event), so a caller may fast-forward the clock.
        Conservative by construction: any tick on which the policy
        would be (re-)invoked — even fruitlessly — reports True, so
        RNG-consuming policies (rand, fitgpp's random fallback) stay
        bit-exact under fast-forward.
        """
        if self.policy.preemptive:
            for j in self.lanes.valid_jobs(True):
                if self.fits_job(j) is not None:
                    return True
                if self.running_be and self._should_trigger(j):
                    return True
        if not self.backfill:
            head = self.lanes.peek(False)
            if head >= 0 and self.fits_job(head) is not None:
                return True
        else:
            popped: List[int] = []
            act = False
            while len(popped) < self.backfill_depth:
                head = self.lanes.pop(False)
                if head < 0:
                    break
                popped.append(head)
                if self.fits_job(head) is not None:
                    act = True
                    break
            for j in popped:
                self.lanes.reinsert(j, False)
            if act:
                return True
        return False

    def min_grace_left(self) -> Optional[int]:
        """Minutes until the next grace expiry, or None."""
        if not self.grace:
            return None
        g = np.fromiter(self.grace, np.int64, count=len(self.grace))
        return int(self.grace_left[g].min())

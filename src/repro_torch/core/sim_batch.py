"""The batched trial engine: B independent trials of the FitGpp
scheduler in one lockstep loop on one device.

The counterpart of the JAX engine under ``jax.vmap`` (``sim_jax.run``
inside ``sweep_fabric._runner``). Every per-job State field carries a
leading trial axis (B, N, ...), ``assign`` is (B, N, M), ``free`` and
``pending_free`` are (B, M, 3), and the scalars ``sim_torch`` keeps on
the host (``t``, ``top_key``, ``n_done``, ``fallback_count``, the event
cache) are (B,) device tensors. ``s`` (f32), ``P`` (i32) and the seed
are per trial; the config is static, as in the JAX axis contract.

Each lane does what ``sim_torch._make_step`` does for one trial: each
host ``if`` on a scalar is a ``torch.where`` over the lanes, each
per-job host value a device gather, and each inner ``while`` (the TE
lane, the BE lane with or without backfill, the signal-until-the-TE-
fits loop, the gang accumulation) a masked loop that runs until no lane
is active, reading "any lane active" back once a round. A lane that has
left a loop, and a lane whose trial is done, is left untouched bit for
bit (a done trial's ``t`` stays its makespan), so every lane's final
State equals ``sim_torch.run`` on its trial, whatever trials share the
batch. In event mode each lane jumps to its own next event. The outer
loop's condition (any lane not done and under ``MAX_TICKS``) is read
every ``CHECK_EVERY`` iterations; a done lane's extra steps are no-ops.

The schedule pass is one batched ``ops.schedule_step`` call over
(B, N, M) (on the card the CUDA kernel, with per-row ``max_sz``,
``max_gp`` and ``s``). Where ``sim_torch`` asks ``would_act`` (a gate
computed without a pass), this engine reads the same verdict off a pass
of the current State: an iteration's first pass is both the gate and
the schedule's first pass, and event mode takes one more after the run
phase (the jump's gate). The TE lane refreshes the pass after each
round, as ``sim_torch`` does after each action. A lane's placement row
comes from a head check of the one job it places (``free`` against
its demand: the pass's ``fits`` row for it), and the head-of-line BE
lane, which after a placement needs only its next head, runs its rounds
on head checks, not passes. Finishers and vacates are retired by their
(lane, job) list (one host read), not over the (B, N, M) mask.

The engine is host-bound: a round is many small launches and ends in a
host read. Every State update is in place, so on the card each TE
round's selection, and every ``BE_ROUNDS`` BE rounds, run as one CUDA
graph replay, captured once per run; the CPU runs the same rounds
eagerly.

Randomness is counter-based, as in ``sim_torch``: job j's uniform is
an integer hash of (the trial's seed, the lane's draw count, j) in
int64 tensor ops (:func:`uniforms`, over ``sim_torch.job_uniforms``),
and a lane's count advances by one at each invocation of a draw site: a
score policy's width-1 selection (its fallback candidate, the running
BE job of the largest uniform, is drawn whether used or not) and a RAND
selection (one uniform per job as its ranks). So a lane's draws depend
on its own trial only: the results do not depend on B, on which trials
share a batch or in what order, nor on the device, and each lane equals
``sim_torch.run`` on its trial, draws and ``draws`` count included.
Exact parity with the JAX engine holds where no draw decides
(``fallback_count == 0`` and no RAND).

Sentinel jobs (``valid=False``) are born DONE: they never arrive, queue,
run or become candidates, and a trial of sentinels only is done at
iteration 0. There is no event ring: a sweep runs untraced, as the JAX
sweep does; a traced run is one trial on ``sim_torch``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.cluster import SimConfig
from repro_torch.core import policy_registry
from repro_torch.core.sim_torch import (_BIG, _EPS, _INF, BOOL, F32, I32,
                                        MAX_TICKS, Jobs, _argmax_key,
                                        _argmin_key, _best_victim_node,
                                        _gang_fit, _node_fits, draw_key,
                                        job_uniforms)
from repro_torch.core.types import DONE, GRACE, NOT_ARRIVED, QUEUED, RUNNING
from repro_torch.kernels import ops
from repro_torch.kernels.schedule_step import covers

I64 = torch.int64
# outer-loop iterations between two reads of "any lane still running"
CHECK_EVERY = 8
# head-of-line BE rounds between two reads of "any lane still placing":
# a round after a lane's last placement is a no-op, and on the card a
# read costs more than a round
BE_ROUNDS = 4


@dataclass
class State:
    """Batched engine state: the JAX ``State``'s fields with a leading
    trial axis (per-job (B, N), ``assign`` (B, N, M), ``free`` and
    ``pending_free`` (B, M, 3), scalars (B,)), all on one device. In
    place of the JAX ``rng`` key each lane counts its draws
    (``draws``, int64)."""
    t: torch.Tensor              # (B,) i32
    state: torch.Tensor          # (B, N) i32
    remaining: torch.Tensor      # (B, N) i32
    assign: torch.Tensor         # (B, N, M) bool
    preempt_count: torch.Tensor  # (B, N) i32
    grace_left: torch.Tensor     # (B, N) i32
    queue_key: torch.Tensor      # (B, N) f32
    top_key: torch.Tensor        # (B,) f32
    finish: torch.Tensor         # (B, N) i32
    te_pending: torch.Tensor     # (B, N) i32
    victim_of: torch.Tensor      # (B, N) i32
    free: torch.Tensor           # (B, M, 3) f32
    pending_free: torch.Tensor   # (B, M, 3) f32
    last_signal: torch.Tensor    # (B, N) i32
    last_vacate: torch.Tensor    # (B, N) i32
    last_resume: torch.Tensor    # (B, N) i32
    awaiting_resume: torch.Tensor  # (B, N) bool
    n_done: torch.Tensor         # (B,) i32
    fallback_count: torch.Tensor  # (B,) i32
    draws: torch.Tensor          # (B,) i64


def init_state(jobs: Jobs, n_nodes: int, node_cap) -> State:
    """The initial State of every trial of the batched ``jobs``."""
    B, N = jobs.submit.shape
    dev = jobs.device
    cap = torch.tensor(node_cap, dtype=F32, device=dev)

    def full(value, dtype, shape=(B, N)):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return State(
        t=full(0, I32, (B,)),
        state=torch.where(jobs.valid, NOT_ARRIVED, DONE).to(I32),
        remaining=jobs.exec_total.clone(),
        assign=full(False, BOOL, (B, N, n_nodes)),
        preempt_count=full(0, I32),
        grace_left=full(0, I32),
        queue_key=full(_INF, F32),
        top_key=full(-1.0, F32, (B,)),
        finish=full(-1, I32),
        te_pending=full(0, I32),
        victim_of=full(-1, I32),
        free=cap.repeat(B, n_nodes, 1),
        pending_free=full(0.0, F32, (B, n_nodes, 3)),
        last_signal=full(-1, I32),
        last_vacate=full(-1, I32),
        last_resume=full(-1, I32),
        awaiting_resume=full(False, BOOL),
        n_done=(~jobs.valid).sum(-1, dtype=I32),
        fallback_count=full(0, I32, (B,)),
        draws=full(0, I64, (B,)),
    )


def state_to_numpy(st: State) -> dict:
    """Every State field as a numpy array with the trial axis first."""
    return {f.name: getattr(st, f.name).cpu().numpy() for f in fields(State)}


def lane(arrays: dict, b: int) -> dict:
    """Trial ``b`` of a :func:`state_to_numpy` dict, its fields named
    and typed as ``sim_torch.state_to_numpy``'s (no ring), for
    comparison with ``sim_torch.state_diff_fields``."""
    return {k: v[b] for k, v in arrays.items()}


def uniforms(seed: torch.Tensor, count: torch.Tensor, n: int
             ) -> torch.Tensor:
    """(B, n) float64 uniforms in [0, 1): entry (b, j) hashes
    (``seed[b]``, ``count[b]``, j) (``sim_torch.draw_key``,
    ``job_uniforms``); the same on every device."""
    j = torch.arange(n, dtype=I64, device=seed.device)
    return job_uniforms(draw_key(seed, count)[:, None], j)


@dataclass
class _Cache:
    """Per lane: next arrival tick, next grace expiry (``_BIG`` when
    none) and queued count, (B,) i32; a pure function of ``(jobs,
    State)`` (:func:`_cache_from_state`) kept up to date in place."""
    next_arrival: torch.Tensor
    next_vacate: torch.Tensor
    n_queued: torch.Tensor


def _next_vacate(st: State, t: torch.Tensor) -> torch.Tensor:
    """Per lane, the tick of the next grace expiry, ``_BIG`` if none."""
    in_grace = st.state == GRACE
    g = torch.where(in_grace, st.grace_left, _BIG).amin(-1)
    return torch.where(in_grace.any(-1), t + g, _BIG)


def _cache_from_state(jobs: Jobs, st: State) -> _Cache:
    nxt = torch.where(st.state == NOT_ARRIVED, jobs.submit, _BIG).amin(-1)
    return _Cache(next_arrival=nxt, next_vacate=_next_vacate(st, st.t),
                  n_queued=(st.state == QUEUED).sum(-1, dtype=I32))


class _Head(NamedTuple):
    """The head-of-line BE lane's per-lane carry (every field (B,) or
    (B, M), updated in place)."""
    j: torch.Tensor          # (B,) i64 head job
    can: torch.Tensor        # (B,) bool: the head is placed this round
    row: torch.Tensor        # (B, M) bool: the head's fit row
    w: torch.Tensor          # (B,) i32: the head's width
    act: torch.Tensor        # (B,) bool: the lane acts this iteration


class _Te(NamedTuple):
    """The TE lane's per-lane carry (every field updated in place)."""
    fit_now: torch.Tensor    # (B, N) i32 the shared pass's fit counts
    fit_pend: torch.Tensor   # (B, N) i32 ... against free + pending
    pending: torch.Tensor    # (B, N) bool TEs not processed yet
    j: torch.Tensor          # (B,) i64 each lane's pick
    w: torch.Tensor          # (B,) i32 its width
    trig: torch.Tensor       # (B,) bool: the pick triggers preemption
    flags: torch.Tensor      # (3,) bool: any pick, any width-1 / gang
    #                          trigger


class _Pass(NamedTuple):
    """One batched fused pass as the lanes read it; every field has the
    trial axis first and stays on the device."""
    fits: torch.Tensor       # (B, N, M) i32
    fit_now: torch.Tensor    # (B, N) i32
    fit_pend: torch.Tensor   # (B, N) i32
    be_pick: torch.Tensor    # (B,) BE job the lane would start next
    be_can: torch.Tensor     # (B,) bool: the pick exists and fits now
    nskip: torch.Tensor      # (B,) i32 skips ahead of the pick (backfill)


def _make_step(cfg: SimConfig, jobs: Jobs, s: torch.Tensor,
               P: torch.Tensor, seed: torch.Tensor, time_mode: str,
               counters: dict):
    """Build ``step(State, _Cache) -> (live, act)``: one tick of every
    lane still running (plus, in event mode, each lane's jump), both
    arguments updated in place; ``live`` and ``act`` (B,) bool say
    which lanes stepped and which ran their schedule pass.
    ``counters["host_reads"]`` and ``counters["passes"]`` count the
    device reads and the batched schedule passes, ``counters["drawn"]``
    ((B,) int64) each lane's selections that a draw decided (a score
    policy's fallback taken, a RAND selection)."""
    dev = jobs.device
    B, N = jobs.submit.shape
    n_nodes = cfg.cluster.n_nodes
    lanes = torch.arange(B, device=dev)
    job_ids = torch.arange(N, device=dev)
    node_cap = torch.tensor(cfg.cluster.node.as_tuple(), dtype=F32,
                            device=dev)
    spec = policy_registry.get_policy(cfg.policy)
    preemptive = spec.preemptive
    backfill = cfg.backfill
    depth = min(int(cfg.backfill_depth), N)    # the gate's scan window
    gp_f = jobs.gp.to(F32)
    be_job = ~jobs.is_te
    no_jobs = torch.zeros((B, N), dtype=BOOL, device=dev)
    # (B, 3) rows for the pass, so its wrapper copies nothing a call
    cap_rows = node_cap.expand(B, 3).contiguous()
    zero3 = torch.zeros((B, 3), dtype=F32, device=dev)
    no_cand_norms = ops.normalizers(jobs.demand, gp_f, no_jobs, node_cap)
    no_lane = torch.full((B,), -1, dtype=I64, device=dev)
    demand_eps = jobs.demand - _EPS      # the fit test's right-hand side
    arrival_keys = job_ids.to(F32)
    ones = torch.ones((B, N), dtype=I32, device=dev)
    P_col = P[:, None]
    s_col = s[:, None]
    # a gang's score policies rank its victims on their total demand
    total_jobs = dataclasses.replace(
        jobs, demand=jobs.demand * jobs.width[..., None].to(F32))

    def read(*xs) -> list:
        """Scalars (0-d tensors of one dtype) back to the host in one
        transfer."""
        counters["host_reads"] += 1
        return torch.stack(xs).tolist()

    def any_lanes(*masks) -> list:
        """For each (B,) mask, whether any lane is set: one transfer."""
        counters["host_reads"] += 1
        return torch.stack(masks).any(-1).tolist()

    def rows(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
        """``x[b, j[b]]`` for every lane (``j`` >= 0), (B,) from (B, N)
        or (B, K) from (B, N, K)."""
        idx = j.view((B, 1) + (1,) * (x.dim() - 2)) \
            .expand((B, 1) + x.shape[2:])
        return x.gather(1, idx).squeeze(1)

    def onehot(j: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """(B, N): job ``j[b]`` of each lane in ``m``."""
        return job_ids == torch.where(m, j, no_lane)[:, None]

    def cand_mask(st):
        return (st.state == RUNNING) & be_job

    def head_mask(st):
        q = st.state == QUEUED
        return q & be_job if preemptive else q

    def schedule_step(st, demand, cand, under, be_q, te_demand, **kw):
        counters["passes"] += 1
        return ops.schedule_step(demand, gp_f, jobs.width, st.queue_key,
                                 st.assign, st.free, st.pending_free,
                                 cand, under, be_q, te_demand, cap_rows,
                                 s=s, **kw)

    def queue_pass(st, be_mask) -> _Pass:
        """The fit tile and the BE queue scan over ``be_mask`` (see
        ``sim_torch``'s ``queue_pass``), for every lane."""
        ps = schedule_step(st, jobs.demand, no_jobs, no_jobs, be_mask, zero3,
                           norms=no_cand_norms)
        if backfill:
            return _Pass(ps.fits, ps.fit_now, ps.fit_pend,
                         ps.be_pick.long().clamp(min=0), ps.be_pick >= 0,
                         ps.nskip)
        h = ps.be_head.long().clamp(min=0)
        can = (ps.be_head >= 0) & (rows(ps.fit_now, h) >= rows(jobs.width, h))
        return _Pass(ps.fits, ps.fit_now, ps.fit_pend, h, can,
                     torch.zeros_like(ps.nskip))

    def gate(st, ps: _Pass) -> torch.Tensor:
        """(B,) would a pass on each lane's State act (``sim_torch``'s
        ``gate``, which equals its ``would_act`` for a fresh pass)."""
        act = ps.be_can & (ps.nskip < depth) if backfill else ps.be_can
        if not preemptive:
            return act
        te_q = (st.state == QUEUED) & jobs.is_te
        trigger = (st.te_pending == 0) & (ps.fit_pend < jobs.width) \
            & cand_mask(st).any(-1, keepdim=True)
        return act | (te_q & ((ps.fit_now >= jobs.width) | trigger)).any(-1)

    def place(st, m, j, nodes) -> None:
        """Lanes ``m`` start job ``j`` on ``nodes`` (B, M). A queued
        job holds no node, so its ``assign`` row becomes ``nodes``."""
        oh = onehot(j, m)
        nodes = nodes & m[:, None]
        idx = j.view(B, 1, 1).expand(B, 1, n_nodes)
        st.state.masked_fill_(oh, RUNNING)
        st.assign.scatter_(1, idx, st.assign.gather(1, idx)
                           | nodes[:, None, :])
        st.queue_key.masked_fill_(oh, _INF)
        st.free -= rows(jobs.demand, j)[:, None, :] * nodes[..., None].to(F32)
        resumed = oh & st.awaiting_resume
        torch.where(resumed, st.t[:, None], st.last_resume,
                    out=st.last_resume)
        st.awaiting_resume ^= resumed

    def first_nodes(row, w):
        """The first ``w[b]`` fitting nodes of each lane's fit row."""
        row = row.to(BOOL)
        return row & (row.cumsum(-1) <= w[:, None])

    def retire(st, mask) -> torch.Tensor:
        """The summed per-node demand (B, M, 3) of the ``mask``-selected
        jobs over their nodes, whose ``assign`` rows it clears. The
        selection is read back (one host read) and only its rows are
        touched, not the (B, N, M) mask; the sum is exact for the
        integer demands of every registered workload in any order, so
        it equals ``sim_torch._release``."""
        counters["host_reads"] += 1
        b, n = mask.nonzero(as_tuple=True)
        freed = torch.zeros((B, n_nodes, 3), dtype=F32, device=dev)
        if b.numel():
            held = st.assign[b, n]
            freed.index_add_(0, b, held[..., None].to(F32)
                             * jobs.demand[b, n][:, None, :])
            st.assign[b, n] = False
        return freed

    def head_fits(st, j):
        """Each lane's fit row for job ``j`` against ``free`` (the
        pass's ``fits`` row for that job, ``sim_torch._node_fits``)."""
        return (st.free >= rows(demand_eps, j)[:, None, :]).all(-1)

    def signal_one(st, m, v, te) -> None:
        """Lanes ``m`` signal running BE job ``v`` for TE job ``te``
        (``sim_torch._signal_one`` per lane)."""
        ohv = onehot(v, m)
        gp_v = rows(jobs.gp, v)
        now = m & (gp_v == 0)                 # GP = 0: vacate inline
        later = m & (gp_v != 0)
        oh_now = ohv & now[:, None]
        oh_later = ohv & later[:, None]
        d = rows(jobs.demand, v)[:, None, :] \
            * rows(st.assign, v)[..., None].to(F32)
        st.preempt_count += ohv.to(I32)
        torch.where(ohv, st.t[:, None], st.last_signal, out=st.last_signal)
        st.awaiting_resume |= ohv
        st.state.masked_fill_(oh_now, QUEUED)
        st.state.masked_fill_(oh_later, GRACE)
        idx = v.view(B, 1, 1).expand(B, 1, n_nodes)
        st.assign.scatter_(1, idx, st.assign.gather(1, idx)
                           & ~now[:, None, None])
        torch.where(oh_now, st.top_key[:, None], st.queue_key,
                    out=st.queue_key)
        st.top_key -= now.to(F32)
        torch.where(now[:, None, None], st.free + d, st.free, out=st.free)
        torch.where(oh_now, st.t[:, None], st.last_vacate,
                    out=st.last_vacate)
        torch.where(later[:, None, None], st.pending_free + d,
                    st.pending_free, out=st.pending_free)
        torch.where(oh_later, gp_v[:, None], st.grace_left,
                    out=st.grace_left)
        torch.where(oh_later, te[:, None].to(I32), st.victim_of,
                    out=st.victim_of)
        st.te_pending += onehot(te, later).to(I32)

    def uniform(st, m) -> torch.Tensor:
        """Each lane's uniforms at its draw count; lanes ``m`` draw."""
        u = uniforms(seed, st.draws, N)
        st.draws += m.to(I64)
        return u

    def score_select(st, m, te) -> torch.Tensor:
        """Eq. 2 eligibility, P cap and Eq. 4 masked argmin per lane,
        with the paper's random fallback (drawn by every lane in ``m``,
        used or not)."""
        cand = cand_mask(st)
        under = st.preempt_count < P_col
        if spec.victim_from_pass:
            be_q = (st.state == QUEUED) & be_job
            main = schedule_step(st, jobs.demand, cand, under, be_q,
                                 rows(jobs.demand, te)).victim.long()
            mask_any = main >= 0
        else:
            score = spec.score(jobs, cand, node_cap, s_col)
            best, _ = _best_victim_node(st.free, st.assign, jobs.demand,
                                        rows(jobs.demand, te))
            mask = cand & (best >= -_EPS) & under
            main = _argmin_key(mask, score)
            mask_any = mask.any(-1)
        rnd = _argmax_key(cand, uniform(st, m))
        drawn = m & ~mask_any
        st.fallback_count += drawn.to(I32)
        counters["drawn"] += drawn.to(I64)
        return torch.where(mask_any, main, rnd)

    def until_fits_select(st, m, te, rank_val) -> None:
        """LRTP/SRTP/RAND per lane: signal victims (best ``rank_val``
        first, under-P-cap first) until the TE fits on the last
        victim's best node, against the free vectors at trigger time."""
        te_d = rows(jobs.demand, te)
        free0 = st.free.clone()
        _, best_node = _best_victim_node(free0, st.assign, jobs.demand,
                                         te_d)
        taken = torch.zeros((B, N), dtype=BOOL, device=dev)
        pending = torch.zeros((B, n_nodes, 3), dtype=F32, device=dev)
        satisfied = torch.zeros(B, dtype=BOOL, device=dev)
        while True:
            cand = cand_mask(st) & ~taken
            m1 = cand & (st.preempt_count < P_col)
            m1_any = m1.any(-1)
            v = _argmax_key(torch.where(m1_any[:, None], m1, cand),
                            rank_val)
            active = m & ~satisfied & cand.any(-1)
            if not any_lanes(active)[0]:
                return
            st.fallback_count += (active & ~m1_any).to(I32)
            signal_one(st, active, v, te)
            node = rows(best_node, v)
            pending[lanes, node] += rows(jobs.demand, v) \
                * active[:, None].to(F32)
            fits = (te_d <= free0[lanes, node] + pending[lanes, node]
                    + _EPS).all(-1)
            satisfied = torch.where(active, fits, satisfied)
            taken |= onehot(v, active)

    def gang_score(st) -> torch.Tensor:
        """The score policy's score over each job's total gang demand;
        fitgpp's from the fused pass."""
        cand = cand_mask(st)
        if not spec.victim_from_pass:
            return spec.score(total_jobs, cand, node_cap, s_col)
        return schedule_step(st, total_jobs.demand, cand,
                             st.preempt_count < P_col, no_jobs,
                             zero3).scores

    def gang_select(st, m, te, rank_val, score=None) -> None:
        """Victims for the blocked gang TEs of lanes ``m``, picked and
        signalled in ``sim_torch._gang_select``'s order: with ``score``
        the min-score single victim that suffices alone, else the
        accumulation in policy order, nothing when even every
        candidate would not suffice; each over-P-cap signal counts
        into ``fallback_count``."""
        te_d = rows(jobs.demand, te)
        w = rows(jobs.width, te)
        free0 = st.free
        cand0 = cand_mask(st)
        under0 = st.preempt_count < P_col
        acc = m
        if score is not None:
            trial = free0[:, None, :, :] + jobs.demand[:, :, None, :] \
                * st.assign[..., None].to(F32)
            nfit1 = covers(trial, (te_d - _EPS)[:, None, None, :]).sum(-1)
            pool = cand0 & (under0 | ~(cand0 & under0).any(-1, keepdim=True))
            single = pool & (nfit1 >= w[:, None])
            v1 = _argmin_key(single, score)
            have = m & single.any(-1)
            acc = m & ~have
        taken = torch.zeros((B, N), dtype=BOOL, device=dev)
        over = torch.zeros((B, N), dtype=BOOL, device=dev)
        seq = torch.full((B, N), -1, dtype=I64, device=dev)
        nsel = torch.zeros(B, dtype=I64, device=dev)
        pending = free0.clone()
        satisfied = _node_fits(pending, te_d).sum(-1) >= w
        while True:
            c = cand0 & ~taken
            m1 = c & under0
            m1_any = m1.any(-1)
            v = _argmax_key(torch.where(m1_any[:, None], m1, c), rank_val)
            active = acc & ~satisfied & c.any(-1)
            n_sig = torch.where(acc & satisfied, nsel, 0)
            go, k_max = read(active.any().to(I64), n_sig.max())
            if not go:
                break
            pending += rows(jobs.demand, v)[:, None, :] \
                * (rows(st.assign, v) & active[:, None])[..., None].to(F32)
            satisfied = torch.where(
                active, _node_fits(pending, te_d).sum(-1) >= w, satisfied)
            ohv = onehot(v, active)
            taken |= ohv
            seq = torch.where(ohv, nsel[:, None], seq)
            over |= ohv & ~m1_any[:, None]
            nsel += active.to(I64)
        if score is not None:
            st.fallback_count += (have & ~rows(under0, v1)).to(I32)
            signal_one(st, have, v1, te)
        for k in range(k_max):
            mk = n_sig > k
            v = (seq == k).to(I32).argmax(-1)
            st.fallback_count += (mk & rows(over, v)).to(I32)
            signal_one(st, mk, v, te)

    def trigger_preemption(st, trig, j, any_w1: bool,
                           any_gang: bool) -> None:
        """Victim selection for the blocked TE ``j`` of lanes ``trig``:
        width-1 TEs through the score or until-fits rule, gangs through
        :func:`gang_select` (a gang draws no fallback candidate; RAND's
        ranks draw for both)."""
        wj = rows(jobs.width, j)
        w1 = trig & (wj == 1)
        gang = trig & (wj > 1)
        if spec.kind == "score":
            if any_w1:
                signal_one(st, w1, score_select(st, w1, j), j)
            if any_gang:
                score = gang_score(st)
                gang_select(st, gang, j, -score, score=score)
            return

        def draw():
            counters["drawn"] += trig.to(I64)
            return uniform(st, trig)

        rank = spec.rank(st, jobs, draw)
        if any_w1:
            until_fits_select(st, w1, j, rank)
        if any_gang:
            gang_select(st, gang, j, rank)

    # the TE lane's loop carry: the shared pass's fit counts, the TEs
    # not processed yet, and each lane's pick, its width and whether it
    # triggers; ``flags`` says whether any lane picked a TE, and whether
    # any triggers for a width-1 TE or a gang
    te = _Te(fit_now=torch.zeros((B, N), dtype=I32, device=dev),
             fit_pend=torch.zeros((B, N), dtype=I32, device=dev),
             pending=torch.zeros((B, N), dtype=BOOL, device=dev),
             j=torch.zeros(B, dtype=I64, device=dev),
             w=torch.zeros(B, dtype=I32, device=dev),
             trig=torch.zeros(B, dtype=BOOL, device=dev),
             flags=torch.zeros(3, dtype=BOOL, device=dev))

    def te_round(st) -> None:
        """One round of the TE lane: each lane picks its first queued,
        unprocessed TE in key order that is actionable (fits now, or
        its preemption trigger is armed), marks every TE queued ahead
        of it processed, and starts it where it fits (its fit row by
        :func:`head_fits`, the pass's row for it). Every write is in
        place, into the State or ``te``."""
        q = (st.state == QUEUED) & te.pending
        trigger = (st.te_pending == 0) & (te.fit_pend < jobs.width) \
            & cand_mask(st).any(-1, keepdim=True)
        can = q & ((te.fit_now >= jobs.width) | trigger)
        j = _argmin_key(can, st.queue_key)
        any_can = can.any(-1)
        w = rows(jobs.width, j)
        ok = any_can & (rows(te.fit_now, j) >= w)
        trig = any_can & ~ok
        te.pending.bitwise_and_(~(
            q & any_can[:, None]
            & (st.queue_key <= rows(st.queue_key, j)[:, None])))
        place(st, ok, j, first_nodes(head_fits(st, j), w))
        te.j.copy_(j)
        te.w.copy_(w)
        te.trig.copy_(trig)
        te.flags.copy_(torch.stack(
            (any_can, trig & (w == 1), trig & (w > 1))).any(-1))

    def te_lane(st, ps: _Pass, act) -> _Pass:
        """Each acting lane processes its queued TEs in key order, only
        the actionable ones; a blocked one triggers victim selection
        (then starts if GP=0 victims made room). Every round refreshes
        the shared pass; on the card the round's selection is one CUDA
        graph replay."""
        te.pending.copy_(act[:, None] & jobs.is_te)
        run_round = round_runner("te", st, te_round, te,
                                 lambda: te.pending.zero_())
        while True:
            te.fit_now.copy_(ps.fit_now)
            te.fit_pend.copy_(ps.fit_pend)
            run_round()
            counters["host_reads"] += 1
            go, any_w1, any_gang = te.flags.tolist()
            if not go:
                return ps
            if any_w1 or any_gang:
                trigger_preemption(st, te.trig, te.j, any_w1, any_gang)
                # GP=0 victims vacate inline: place the TE now, before
                # the BE lane can reclaim the freed nodes
                ok2, nodes = _gang_fit(st.free, rows(jobs.demand, te.j),
                                       te.w)
                place(st, te.trig & ok2, te.j, nodes)
            ps = queue_pass(st, head_mask(st))

    # the BE lane's loop carry: each lane's head, whether it is placed
    # this round, its fit row and width, and whether the lane acts
    head = _Head(j=torch.zeros(B, dtype=I64, device=dev),
                 can=torch.zeros(B, dtype=BOOL, device=dev),
                 row=torch.zeros((B, n_nodes), dtype=BOOL, device=dev),
                 w=torch.zeros(B, dtype=I32, device=dev),
                 act=torch.zeros(B, dtype=BOOL, device=dev))
    graphs = {}       # (round, id(State)) -> (State, its CUDA graph)

    def round_runner(name, st, round_fn, carry, quiet):
        """A callable that runs ``round_fn(st)``: on the card one replay
        of its CUDA graph (the round's launches cost the host one call),
        captured once per State after a warm-up round that ``quiet()``
        makes a no-op (no lane acts); ``carry`` is restored after the
        capture. On the CPU the round runs as it is."""
        if dev.type != "cuda":
            return lambda: round_fn(st)
        key = (name, id(st))
        if key not in graphs or graphs[key][0] is not st:
            saved = [x.clone() for x in carry]
            quiet()
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                round_fn(st)
            torch.cuda.current_stream(dev).wait_stream(side)
            quiet()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                round_fn(st)
            for x, v in zip(carry, saved):
                x.copy_(v)
            graphs[key] = (st, graph)
        return graphs[key][1].replay

    def be_round(st) -> None:
        """One round of the head-of-line BE lane: lanes ``head.can``
        place their head, then every lane checks its next head (whether
        it fits and its fit row: the values the pass's ``be_head``,
        ``fit_now`` and ``fits`` hold for that one job, as
        ``sim_torch``'s ``would_act`` computes them). Every write is in
        place, into the State or ``head``."""
        place(st, head.can, head.j, first_nodes(head.row, head.w))
        be_q = head_mask(st)
        head.j.copy_(_argmin_key(be_q, st.queue_key))
        head.row.copy_(head_fits(st, head.j))
        head.w.copy_(rows(jobs.width, head.j))
        head.can.copy_(head.act & be_q.any(-1)
                       & (head.row.sum(-1) >= head.w))

    def be_rounds(st) -> None:
        for _ in range(BE_ROUNDS):
            be_round(st)

    def quiet_head():
        head.act.zero_()
        head.can.zero_()

    def be_queue(st, ps: _Pass, act) -> None:
        """FIFO head-of-line BE lane: each acting lane places its head
        while it fits. The first head comes from the pass ``ps``; after
        a placement the lane needs only its next head, so the rounds
        run on head checks (:func:`be_round`), not whole passes,
        ``BE_ROUNDS`` between two reads; on the card those are one CUDA
        graph replay."""
        head.act.copy_(act)
        head.j.copy_(ps.be_pick)
        head.can.copy_(act & ps.be_can)
        head.row.copy_(rows(ps.fits, ps.be_pick))
        head.w.copy_(rows(jobs.width, ps.be_pick))
        run_rounds = round_runner("be", st, be_rounds, head, quiet_head)
        while any_lanes(head.can)[0]:
            run_rounds()

    def be_queue_backfill(st, ps: _Pass, act) -> None:
        """Bounded first-fit backfill per lane (``sim_torch``'s
        ``be_queue_backfill``)."""
        skipped = torch.zeros((B, N), dtype=BOOL, device=dev)
        scanned = torch.zeros(B, dtype=I32, device=dev)
        while True:
            can = act & ps.be_can & (scanned + ps.nskip < cfg.backfill_depth)
            if not any_lanes(can)[0]:
                return
            j = ps.be_pick
            q = head_mask(st) & ~skipped
            skipped |= q & (ps.fit_now < jobs.width) & can[:, None] \
                & (st.queue_key < rows(st.queue_key, j)[:, None])
            scanned += torch.where(can, ps.nskip, 0)
            place(st, can, j, first_nodes(rows(ps.fits, j),
                                      rows(jobs.width, j)))
            ps = queue_pass(st, head_mask(st) & ~skipped)

    def arrivals(st, cache: _Cache, live) -> None:
        """Queue every submitted job of the lanes whose next arrival is
        due, keyed by arrival order (= row index)."""
        fire = live & (cache.next_arrival <= st.t)
        arrive = fire[:, None] & (jobs.submit <= st.t[:, None]) \
            & (st.state == NOT_ARRIVED)
        st.state.masked_fill_(arrive, QUEUED)
        torch.where(arrive, arrival_keys, st.queue_key, out=st.queue_key)
        nxt = torch.where(st.state == NOT_ARRIVED, jobs.submit,
                          _BIG).amin(-1)
        cache.next_arrival = torch.where(fire, nxt, cache.next_arrival)
        cache.n_queued += arrive.sum(-1, dtype=I32)

    def vacates(st, cache: _Cache, live) -> None:
        """Vacate grace-expired victims of the lanes whose next expiry
        is due: requeue on top, FIFO among same-tick vacates in
        job-index order."""
        fire = live & (cache.next_vacate <= st.t)
        vac = fire[:, None] & (st.state == GRACE) & (st.grace_left <= 0)
        rank = vac.cumsum(-1) - 1
        te_dec = torch.zeros((B, N + 1), dtype=I32, device=dev).scatter_add_(
            1, torch.where(vac, st.victim_of, N).long(), ones)[:, :N]
        freed = retire(st, vac)
        torch.where(vac, st.top_key[:, None] - rank.to(F32), st.queue_key,
                    out=st.queue_key)
        st.free += freed
        st.pending_free -= freed
        torch.where(vac, st.t[:, None], st.last_vacate, out=st.last_vacate)
        st.te_pending -= te_dec
        st.victim_of.masked_fill_(vac, -1)
        st.state.masked_fill_(vac, QUEUED)
        n_vac = vac.sum(-1, dtype=I32)
        st.top_key -= n_vac.to(F32)
        cache.next_vacate = torch.where(fire, _next_vacate(st, st.t),
                                        cache.next_vacate)
        cache.n_queued += n_vac

    def schedule(st, cache: _Cache, act, ps: _Pass) -> None:
        """The full schedule pass of the acting lanes from their first
        pass ``ps``, and their cache refresh."""
        if preemptive:
            ps = te_lane(st, ps, act)
        (be_queue_backfill if backfill else be_queue)(st, ps, act)
        queued = st.state == QUEUED
        cache.next_vacate = torch.where(act, _next_vacate(st, st.t),
                                        cache.next_vacate)
        cache.n_queued = torch.where(act, queued.sum(-1, dtype=I32),
                                     cache.n_queued)

    def run_minute(st, cache: _Cache, live) -> None:
        """Each live lane: decrement running clocks, retire finishers in
        one bulk update, count grace down, advance ``t``."""
        running = live[:, None] & (st.state == RUNNING)
        st.remaining -= running.to(I32)
        fin = running & (st.remaining <= 0)
        st.state.masked_fill_(fin, DONE)
        torch.where(fin, st.t[:, None] + 1, st.finish, out=st.finish)
        st.free += retire(st, fin)
        st.n_done += fin.sum(-1, dtype=I32)
        dec = (live & (cache.next_vacate < _BIG))[:, None] \
            & (st.state == GRACE)
        st.grace_left -= dec.to(I32)
        st.t += live.to(I32)

    def jump(st, cache: _Cache, jm) -> None:
        """Lanes ``jm`` advance to their next event in one step (next
        arrival, grace expiry or finish), bulk-decrementing the clocks;
        a lane with nothing queued drains: it jumps to its next arrival
        or vacate, retiring every finisher on the way."""
        t1 = st.t
        running = st.state == RUNNING
        in_grace = st.state == GRACE
        d_ev = torch.minimum(cache.next_arrival - t1, cache.next_vacate - t1)
        span = (MAX_TICKS - t1).clamp(min=0)
        drain = jm & (cache.n_queued == 0)
        last_fin = torch.where(running, st.remaining, 0).amax(-1)
        dt_drain = torch.where(d_ev >= _BIG - t1, last_fin,
                               torch.minimum(d_ev.clamp(min=0), span))
        d_fin = torch.where(running, st.remaining - 1, MAX_TICKS).amin(-1)
        dt_on = torch.minimum(torch.minimum(d_ev, d_fin).clamp(min=0), span)
        dt = torch.where(drain, dt_drain, torch.where(jm, dt_on, 0))
        fin = drain[:, None] & running & (st.remaining <= dt[:, None])
        torch.where(fin, t1[:, None] + st.remaining, st.finish,
                    out=st.finish)
        st.remaining -= torch.where(fin, st.remaining,
                                    dt[:, None] * running.to(I32))
        st.state.masked_fill_(fin, DONE)
        st.free += retire(st, fin)
        st.n_done += fin.sum(-1, dtype=I32)
        st.grace_left -= dt[:, None] * in_grace.to(I32)
        st.t += dt

    def step(st: State, cache: _Cache):
        live = (st.n_done < N) & (st.t < MAX_TICKS)
        arrivals(st, cache, live)
        vacates(st, cache, live)
        ps = queue_pass(st, head_mask(st))
        # every schedule action starts from a queued job
        act = live & (cache.n_queued > 0) & gate(st, ps)
        schedule(st, cache, act, ps)
        run_minute(st, cache, live)
        if time_mode == "tick":
            return live, act
        # the gate on the State after the run phase: where no job
        # finished, the run phase changed only clocks the gate does not
        # read, so this is ``sim_torch``'s lanes' exit evaluation; where
        # jobs finished, its re-evaluation (one pass for both)
        hold = (cache.n_queued > 0) & gate(st, queue_pass(st, head_mask(st)))
        jump(st, cache, live & ~((st.n_done >= N) | hold))
        return live, act

    return step


def _per_trial(x, dtype, B: int, dev) -> torch.Tensor:
    """A (B,) tensor of ``dtype`` on ``dev`` from a scalar or vector."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(
            x, dtype=torch.empty((), dtype=dtype).numpy().dtype))
    t = x.to(dtype=dtype, device=dev)
    if t.dim() == 0:
        t = t.expand(B)
    if tuple(t.shape) != (B,):
        raise ValueError(f"per-trial vector has shape {tuple(t.shape)}; "
                         f"expected ({B},)")
    return t.contiguous()


def run(cfg: SimConfig, jobs: Jobs, s, P, seed,
        time_mode: Optional[str] = None,
        stats: Optional[dict] = None) -> State:
    """Run every trial of the batched ``jobs`` (each field (B, N, ...))
    to its end on the jobs' device; trial b under ``s[b]``, ``P[b]``
    and ``seed[b]`` (scalars broadcast). Returns the final batched
    State.

    ``time_mode`` defaults to ``cfg.time_mode``. ``stats``, when given,
    receives ``iterations`` (loop iterations), ``acting_iterations``
    (iterations where some lane ran its schedule pass), ``host_reads``
    (device-to-host reads of the loop), ``passes`` (batched schedule
    passes), ``launches`` (``schedule_step`` kernel launches,
    ``ops.LAUNCHES``; one batched launch counts once, 0 on the CPU),
    and per lane ``lane_iterations`` / ``lane_acting`` (numpy; each
    equals ``sim_torch.run``'s ``iterations`` / ``acting_ticks`` on
    that trial) and ``lane_drawn``, the selections a draw decided (a
    score policy's fallback taken, a RAND selection). A lane with
    ``lane_drawn == 0`` made every decision as ``sim_torch`` and the
    JAX engine make it on that trial: their States are equal."""
    time_mode = cfg.time_mode if time_mode is None else time_mode
    if time_mode not in ("tick", "event"):
        raise ValueError(f"unknown time_mode {time_mode!r}; "
                         "one of ('tick', 'event')")
    if jobs.submit.dim() != 2:
        raise ValueError("run needs batched jobs, each field (B, N, ...)")
    dev = jobs.device
    B, N = jobs.submit.shape
    s = _per_trial(s, F32, B, dev)
    P = _per_trial(P, I32, B, dev)
    seed = _per_trial(seed, I64, B, dev)
    st = init_state(jobs, cfg.cluster.n_nodes, cfg.cluster.node.as_tuple())
    counters = {"host_reads": 0, "passes": 0,
                "drawn": torch.zeros(B, dtype=I64, device=dev)}
    step = _make_step(cfg, jobs, s, P, seed, time_mode, counters)
    cache = _cache_from_state(jobs, st)
    launches0 = ops.LAUNCHES["schedule_step"]
    lane_iterations = torch.zeros(B, dtype=I64, device=dev)
    lane_acting = torch.zeros(B, dtype=I64, device=dev)
    acting = torch.zeros((), dtype=I64, device=dev)
    iterations = 0
    while True:
        counters["host_reads"] += 1
        if not bool(((st.n_done < N) & (st.t < MAX_TICKS)).any()):
            break
        for _ in range(CHECK_EVERY):
            live, act = step(st, cache)
            lane_iterations += live
            lane_acting += act
            acting += act.any()
            iterations += 1
    if stats is not None:
        stats.update(iterations=iterations, acting_iterations=int(acting),
                     host_reads=counters["host_reads"],
                     passes=counters["passes"],
                     launches=ops.LAUNCHES["schedule_step"] - launches0,
                     lane_iterations=lane_iterations.cpu().numpy(),
                     lane_acting=lane_acting.cpu().numpy(),
                     lane_drawn=counters["drawn"].cpu().numpy())
    return st


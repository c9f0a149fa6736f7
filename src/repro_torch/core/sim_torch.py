"""The FitGpp scheduler engine in PyTorch.

The port of the JAX package's ``core/sim_jax.py``: tick and event time
modes, every policy of the port's table, gang (multi-node) jobs and the
bounded first-fit BE backfill (``SimConfig.backfill``). Per-job state
is struct-of-arrays tensors on one device (int32/float32/bool, as in
the JAX ``Jobs``/``State``), updated in place; the scalars that steer
the loop (``t``, ``top_key``, ``n_done``, ``fallback_count``) and the
event cache live on the host as Python numbers, and every
``lax.cond``/``while_loop`` of the JAX engine becomes a host ``if`` or
``while`` on scalars read back from the device, several per transfer
where the code allows it. That is exact for a single trial.

The schedule pass is the fused ``kernels/ops.schedule_step``: on a CUDA
device it launches the hand-written kernel, on the CPU it runs the
plain PyTorch version. Each acting tick computes one shared pass and
threads it through the TE lane, the BE lane and the gate, as the JAX
engine does; fitgpp's victim selection reads ``.victim`` from the same
fused pass.

Gang jobs need ``width`` nodes at once, each covering the per-node
demand: placement is all-or-nothing first fit on the ``(N, nodes)``
``State.assign`` mask, victims vacate all their nodes at once, and a
blocked gang TE selects its victims with :func:`_gang_select` (the
single victim whose eviction alone suffices, else an accumulation in
policy order that signals nothing when even every candidate would not
suffice). With ``backfill`` the BE lane starts the first fitting queued
job in key order while at most ``backfill_depth`` blocked jobs are
skipped in a pass; the fused pass's ``be_pick``/``nskip`` carry that
scan.

Randomness (the score policies' fallback candidate, RAND's ranks) is
counter-based, as in the batched engine (``core/sim_batch.py``): job
j's uniform hashes (the run's seed, the State's draw count
``State.draws``, j's arrival key) in int64 tensor ops
(:func:`job_uniforms`), so a draw gives the same bits on every device.
The count advances by one at each invocation of a draw site, the
batched engine's: a score policy's width-1 selection (its fallback
candidate, the running BE job of the largest uniform, takes its draw
number whether used or not; its uniforms are hashed only when it is
used) and a RAND selection (one uniform per job as its ranks,
width 1 or a gang). A score policy's gang selection draws nothing. So
this engine equals ``sim_batch`` at B = 1 job for job, draws included,
and the stream engine, which keys a draw on each job's global arrival
order (``Jobs.akey``), equals this engine's monolithic run whatever
slot a job lands in. Exact parity with the JAX engine, whose draws come
from ``jax.random`` keys, holds where no draw decides
(``fallback_count == 0`` and no RAND).

``trace=True`` records every scheduler event into the State's ring
buffer (``State.ev_buf``, the ``obs/ring.py`` layout), in the JAX
engine's order, so with the same capacity the buffer equals the JAX
engine's bit for bit; decode it with :func:`decode_trace`. The row
count ``ev_n`` is a host int and every emission site already knows its
count on the host, so the ring adds no device read. ``trace=False``
(the default) carries a zero-size ring and runs no emission code.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.cluster import SimConfig
from repro_torch.core import policy_registry
from repro_torch.core.engine.placement import FIT_EPS
from repro_torch.core.types import (DONE, GRACE, NOT_ARRIVED, QUEUED,
                                    RUNNING, JobSet)
from repro_torch.draws import M32, _mix32_host, mix32
from repro_torch.kernels import ops
from repro_torch.kernels.schedule_step import covers
from repro_torch.obs import ring as obs_ring
from repro_torch.obs import schema as obs_schema

_INF = float("inf")
_EPS = FIT_EPS
_BIG = 1 << 30        # "no event pending" sentinel (int32-safe)
MAX_TICKS = 1 << 22
I32, F32, BOOL = torch.int32, torch.float32, torch.bool
I64 = torch.int64


@dataclass
class Jobs:
    """Static workload tensors; ``demand`` is per node, ``valid``
    False marks sentinel rows (born DONE, never scheduled)."""
    submit: torch.Tensor      # (N,) i32
    exec_total: torch.Tensor  # (N,) i32
    demand: torch.Tensor      # (N, 3) f32
    is_te: torch.Tensor       # (N,) bool
    gp: torch.Tensor          # (N,) i32
    width: torch.Tensor       # (N,) i32 gang width (>= 1)
    valid: torch.Tensor       # (N,) bool
    # (N,) f32 global arrival order, or None: row index is arrival order
    # (every monolithic job set). The stream engine recycles slots and
    # stamps each job's sequence number here; arrival keys, requeue
    # ranks and victim tie-breaks then key on it. Exact below 2^24.
    akey: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.submit.device

    def map(self, fn) -> "Jobs":
        """Jobs with ``fn`` applied to every tensor field (a None
        ``akey`` stays None)."""
        return Jobs(**{f.name: None if getattr(self, f.name) is None
                       else fn(getattr(self, f.name))
                       for f in fields(self)})


@dataclass
class State:
    """Engine state, field for field the JAX ``State``. Tensors live on
    the jobs' device; ``t``, ``top_key``, ``n_done``,
    ``fallback_count`` and ``ev_n`` are host scalars. In place of the
    JAX ``rng`` key the State carries the run's ``seed`` and its draw
    count ``draws`` (host ints; module docstring).

    The event ring: ``ev_buf`` is ``(capacity + 1, 4 + n_words)`` int32
    (``obs/ring.py``; the last row is the dump row and stays zero),
    ``ev_n`` counts every emitted row, dropped past capacity or not.
    An untraced State carries a ``(0, 0)`` ``ev_buf`` and ``ev_n`` 0."""
    t: int
    state: torch.Tensor          # (N,) i32
    remaining: torch.Tensor      # (N,) i32
    assign: torch.Tensor         # (N, n_nodes) bool placement mask
    preempt_count: torch.Tensor  # (N,) i32
    grace_left: torch.Tensor     # (N,) i32
    queue_key: torch.Tensor      # (N,) f32, +inf when not queued
    top_key: float               # f32 value: next requeue-on-top key
    finish: torch.Tensor         # (N,) i32
    te_pending: torch.Tensor     # (N,) i32
    victim_of: torch.Tensor      # (N,) i32
    free: torch.Tensor           # (n_nodes, 3) f32
    pending_free: torch.Tensor   # (n_nodes, 3) f32
    last_signal: torch.Tensor    # (N,) i32
    last_vacate: torch.Tensor    # (N,) i32
    last_resume: torch.Tensor    # (N,) i32
    awaiting_resume: torch.Tensor  # (N,) bool
    n_done: int
    seed: int
    draws: int
    fallback_count: int
    ev_buf: torch.Tensor         # (cap + 1, 4 + n_words) i32, or (0, 0)
    ev_n: int


_JOB_DTYPES = {"submit": I32, "exec_total": I32, "demand": F32,
               "is_te": BOOL, "gp": I32, "width": I32, "valid": BOOL}
_HOST_SCALARS = {"t": np.int32, "top_key": np.float32, "n_done": np.int32,
                 "draws": np.int64, "fallback_count": np.int32,
                 "ev_n": np.int32}
_STATE_DTYPES = {"state": I32, "remaining": I32, "assign": BOOL,
                 "preempt_count": I32, "grace_left": I32, "queue_key": F32,
                 "finish": I32, "te_pending": I32, "victim_of": I32,
                 "free": F32, "pending_free": F32, "last_signal": I32,
                 "last_vacate": I32, "last_resume": I32,
                 "awaiting_resume": BOOL}


def _tensor(x, dtype, dev) -> torch.Tensor:
    """A fresh tensor (never a view of the caller's array: the engine
    updates State in place)."""
    return torch.tensor(np.asarray(x)).to(dtype=dtype, device=dev)


def jobs_from_numpy(arrays: dict, device=None) -> Jobs:
    """Jobs from numpy arrays named as the JAX ``Jobs`` fields
    (``valid`` optional, default all True; ``akey`` optional, default
    None)."""
    dev = _device.resolve(device)
    arrays = dict(arrays)
    arrays.setdefault("valid", np.ones(len(arrays["submit"]), bool))
    akey = arrays.get("akey")
    return Jobs(**{f: _tensor(arrays[f], dt, dev)
                   for f, dt in _JOB_DTYPES.items()},
                akey=None if akey is None else _tensor(akey, F32, dev))


def jobs_from_jobset(js: JobSet, device=None) -> Jobs:
    return jobs_from_numpy(dict(
        submit=js.submit, exec_total=js.exec_total, demand=js.demand,
        is_te=js.is_te, gp=js.gp, width=js.n_nodes), device)


def draw_key(seed, count):
    """The key of a run's draw number ``count``: a 32-bit hash of
    (seed, count), host ints or (B,) int64 tensors alike."""
    if isinstance(seed, torch.Tensor):
        return mix32(mix32(seed.to(I64) & M32) ^ (count.to(I64) & M32))
    return _mix32_host(_mix32_host(int(seed)) ^ (int(count) & M32))


def job_uniforms(key, ids: torch.Tensor) -> torch.Tensor:
    """float64 uniforms in [0, 1), one per entry of ``ids`` (int64 job
    ids below 2^32, broadcast against ``key``): 53 bits from two 32-bit
    hashes of ``key ^ id``, int64 tensor ops only, so the same on every
    device. ``mix32`` is a bijection of 32-bit words, so distinct ids
    under one key never tie."""
    h1 = mix32(key ^ ids)
    h2 = mix32(h1 ^ 0x9E3779B9)
    return ((h1 << 21) | (h2 >> 11)).to(torch.float64) * 2.0 ** -53


def _ring_buffer(n_nodes: int, capacity: int, dev) -> torch.Tensor:
    shape = ((capacity + 1, obs_ring.HEADER_WORDS
              + obs_ring.n_node_words(n_nodes)) if capacity > 0 else (0, 0))
    return torch.zeros(shape, dtype=I32, device=dev)


def init_state(jobs: Jobs, n_nodes: int, node_cap, seed: int,
               trace_capacity: int = 0) -> State:
    """The initial State; ``trace_capacity`` > 0 gives it an event ring
    of that many rows (0: untraced)."""
    N = jobs.submit.shape[0]
    dev = jobs.device
    cap = torch.tensor(node_cap, dtype=F32, device=dev)

    def full(value, dtype, shape=(N,)):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return State(
        t=0,
        # sentinel (padding) jobs are born DONE: never arrive, never run
        state=torch.where(jobs.valid, NOT_ARRIVED, DONE).to(I32),
        # a copy: the engine updates ``remaining`` in place
        remaining=jobs.exec_total.clone(),
        assign=full(False, BOOL, (N, n_nodes)),
        preempt_count=full(0, I32),
        grace_left=full(0, I32),
        queue_key=full(_INF, F32),
        top_key=-1.0,
        finish=full(-1, I32),
        te_pending=full(0, I32),
        victim_of=full(-1, I32),
        free=cap.repeat(n_nodes, 1),
        pending_free=full(0.0, F32, (n_nodes, 3)),
        last_signal=full(-1, I32),
        last_vacate=full(-1, I32),
        last_resume=full(-1, I32),
        awaiting_resume=full(False, BOOL),
        n_done=int((~jobs.valid).sum()),
        seed=int(seed),
        draws=0,
        fallback_count=0,
        ev_buf=_ring_buffer(n_nodes, int(trace_capacity), dev),
        ev_n=0,
    )


def state_from_numpy(arrays: dict, seed: int, device=None) -> State:
    """An untraced State of the run seeded ``seed`` from numpy arrays
    named as the JAX ``State`` fields (``rng``, ``ev_buf`` and ``ev_n``
    are not read: the ring is zero-size and ``ev_n`` 0) and the draw
    count ``draws`` (0 when absent, as in a JAX State)."""
    dev = _device.resolve(device)
    kw = {f: _tensor(arrays[f], dt, dev) for f, dt in _STATE_DTYPES.items()}
    kw["t"] = int(arrays["t"])
    kw["top_key"] = float(np.float32(arrays["top_key"]))
    kw["n_done"] = int(arrays["n_done"])
    kw["fallback_count"] = int(arrays["fallback_count"])
    kw["draws"] = int(arrays.get("draws", 0))
    return State(seed=int(seed), ev_buf=_ring_buffer(0, 0, dev), ev_n=0,
                 **kw)


def state_to_numpy(st: State) -> dict:
    """Every State field but ``seed`` (a parameter of the run, which
    :func:`state_from_numpy` takes apart) as numpy; ``draws`` as
    ``sim_batch.state_to_numpy`` names it."""
    out = {}
    for f in fields(State):
        x = getattr(st, f.name)
        if f.name == "seed":
            continue
        if f.name in _HOST_SCALARS:
            out[f.name] = np.asarray(x, _HOST_SCALARS[f.name])
        else:
            out[f.name] = x.cpu().numpy()
    return out


def state_diff_fields(a: dict, b: dict) -> list:
    """Names of fields that differ between two ``state_to_numpy``
    dicts; empty means the States are equal bit for bit."""
    return [f for f in a if not np.array_equal(a[f], b[f])]


def _ints(*xs) -> list:
    """Read scalar tensors back to the host in one transfer."""
    return torch.stack([x.reshape(()).to(torch.int64) for x in xs]).tolist()


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d device index, without a host read."""
    return x.index_select(0, i.reshape(1))[0]


# ---------------------------------------------------------------------------
# event cache — exact scalars derived from State, kept on the host
# ---------------------------------------------------------------------------

@dataclass
class _Cache:
    """Next arrival tick, next grace expiry (``_BIG`` when none), queued
    TE count and queued total: a pure function of ``(jobs, State)``
    (:func:`_cache_from_state`) kept up to date by the sites that change
    them, so no-op ticks cost no device reads."""
    next_arrival: int
    next_vacate: int
    n_q_te: int
    n_queued: int


def _next_vacate(st: State) -> tuple:
    in_grace = st.state == GRACE
    return in_grace.any(), torch.where(in_grace, st.grace_left, _BIG).min()


def _cache_from_state(jobs: Jobs, st: State,
                      ext_arrival: Optional[int] = None) -> _Cache:
    """``ext_arrival``: the submit tick of the next job outside ``jobs``
    (a streamed round's boundary, or None), folded into
    ``next_arrival`` so no event jump passes it."""
    queued = st.state == QUEUED
    nxt = torch.where(st.state == NOT_ARRIVED, jobs.submit, _BIG).min()
    any_g, g = _next_vacate(st)
    nxt, any_g, g, n_q_te, n_queued = _ints(
        nxt, any_g, g, (queued & jobs.is_te).sum(), queued.sum())
    if ext_arrival is not None:
        nxt = min(nxt, int(ext_arrival))
    return _Cache(next_arrival=nxt,
                  next_vacate=st.t + g if any_g else _BIG,
                  n_q_te=n_q_te, n_queued=n_queued)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

# ``_node_fits``, ``_gang_fit``, ``_best_victim_node`` and the masked
# argmin/argmax also take a leading batch axis (free (B, M, 3), demand
# (B, N, 3), d (B, 3), w (B,), masks (B, N)) and reduce per row: the
# batched engine (``core/sim_batch.py``) runs them on B trials at once.

def _node_fits(free: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(M,) bool: nodes whose free vector covers the demand ``d``."""
    return covers(free, (d - _EPS).unsqueeze(-2))


def _fit_counts(free: torch.Tensor, demand: torch.Tensor) -> torch.Tensor:
    """(N,) i32: per job, the nodes whose free vector covers it."""
    return covers(free[None, :, :], (demand - _EPS)[:, None, :]) \
        .sum(1, dtype=I32)


def _gang_fit(free: torch.Tensor, d: torch.Tensor, w):
    """All-or-nothing first fit: (ok, mask of the first ``w`` nodes
    whose free vector covers the per-node demand ``d``); the mask is
    all-False when the gang does not fit. ``ok`` stays on the device."""
    fits = _node_fits(free, d)
    w = torch.as_tensor(w, device=free.device)
    ok = fits.sum(-1) >= w
    return ok, fits & (fits.cumsum(-1) <= w.unsqueeze(-1)) & ok.unsqueeze(-1)


def _gang_fits(free: torch.Tensor, demand: torch.Tensor,
               width: torch.Tensor) -> torch.Tensor:
    """(N,) bool: at least ``width[j]`` nodes of ``free`` each cover
    ``demand[j]`` (``_gang_fit``'s verdict for every job at once)."""
    return _fit_counts(free, demand) >= width


def _backfill_would_act(be_q: torch.Tensor, fits: torch.Tensor,
                        key: torch.Tensor, depth: int) -> torch.Tensor:
    """Does any of the first ``depth`` queued BE jobs in key order fit?
    The JAX engine scans ``argsort(keys)[:depth]``; the same verdict
    without a sort: the first fitting job in key order lies in that
    window iff fewer than ``depth`` queued jobs are keyed ahead of it
    (queue keys are unique, and every job ahead of it does not fit)."""
    mq = be_q & fits
    pick_key = torch.where(mq, key, _INF).min()
    ahead = (be_q & (key < pick_key)).sum()
    return mq.any() & (ahead < depth)


def _best_victim_node(free, assign, demand, te_d):
    """Eq. 2 glue: per job, the max over assigned nodes of the min
    slack ``(free + own demand) - te_demand``, and that node; rows with
    no assignment get ``-inf`` (never eligible)."""
    sl = (free.unsqueeze(-3) + demand.unsqueeze(-2)) \
        - te_d[..., None, None, :]
    slack = torch.minimum(torch.minimum(sl[..., 0], sl[..., 1]), sl[..., 2])
    slack = torch.where(assign, slack, -_INF)
    return slack.amax(-1), slack.argmax(-1)


def _argmin_key(mask: torch.Tensor, val: torch.Tensor,
                akey: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked argmin; among tied minima the smallest ``akey`` (global
    arrival order) wins, as ``sim_jax._argmin_key`` picks it. With
    ``akey`` None (row index is arrival order) the first minimum."""
    if akey is None:
        return torch.where(mask, val, _INF).argmin(-1)
    best = torch.where(mask, val, _INF).amin(-1, keepdim=True)
    return torch.where(mask & (val == best), akey, _INF).argmin(-1)


def _argmax_key(mask: torch.Tensor, val: torch.Tensor,
                akey: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked argmax twin of :func:`_argmin_key` (ties: smallest
    ``akey``)."""
    if akey is None:
        return torch.where(mask, val, -_INF).argmax(-1)
    best = torch.where(mask, val, -_INF).amax(-1, keepdim=True)
    return torch.where(mask & (val == best), akey, _INF).argmin(-1)


def _release(assign: torch.Tensor, demand: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Summed per-node demand of the ``mask``-selected jobs over their
    nodes, (nodes, 3). Exact for the integer demands of the paper's
    workloads, whatever the summation order."""
    sel = (assign & mask[:, None]).to(F32)
    return sel.T @ demand


# ---------------------------------------------------------------------------
# the event ring (obs/ring.py layout, the JAX engine's emission order)
# ---------------------------------------------------------------------------

class _Ring:
    """Appends event rows to ``State.ev_buf``. ``State.ev_n`` is a host
    int and every caller knows its row count on the host, so no append
    reads the device: rows past capacity are dropped here on the host,
    and rows selected by a mask are placed by a cumsum scatter (never
    ``nonzero``, which waits for the device). Rows are zero until
    written and each is written once; non-placement rows keep their
    zero node words."""

    def __init__(self, n_nodes: int, n_jobs: int, dev) -> None:
        # (n_words, n_nodes) powers of two as int32 (bit 31 negative):
        # a masked sum of distinct bits is the packed word's int32
        # bit pattern, exact in any summation order
        w = obs_ring.node_mask_weights(n_nodes).view(np.int32)
        self.weights = torch.from_numpy(w.copy()).to(dev)
        self.job_ids = torch.arange(n_jobs, dtype=I32, device=dev)

    @staticmethod
    def _cap(st: State) -> int:
        return st.ev_buf.shape[0] - 1

    def _col(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(I32)
        return torch.full_like(self.job_ids, int(v))

    def rows(self, st: State, rows) -> None:
        """Rows ``(t, code, job, aux)`` known on the host."""
        r0 = st.ev_n
        st.ev_n += len(rows)
        keep = max(0, min(len(rows), self._cap(st) - r0))
        if keep:
            hdr = torch.tensor([[int(v) for v in row] for row in rows[:keep]],
                               dtype=I32)
            if st.ev_buf.is_cuda:
                # pinned, so the copy is queued and the host never waits
                hdr = hdr.pin_memory()
            st.ev_buf[r0:r0 + keep, :obs_ring.HEADER_WORDS].copy_(
                hdr, non_blocking=True)

    def place(self, st: State, j: int, resumed: torch.Tensor,
              nodes: torch.Tensor) -> None:
        """START, or RESUME when ``resumed`` (0-d bool), with the node
        mask packed into the words."""
        r = st.ev_n
        st.ev_n += 1
        if r >= self._cap(st):
            return
        row = st.ev_buf[r]
        row[0] = st.t
        row[2] = j
        row[3] = -1
        row[1] = torch.where(resumed, obs_schema.RESUME, obs_schema.START)
        row[obs_ring.HEADER_WORDS:] = torch.where(
            nodes[None, :], self.weights, 0).sum(1, dtype=I32)

    def masked(self, st: State, mask: torch.Tensor, k: int, t, codes,
               auxes) -> None:
        """For each of the ``k`` set bits of ``mask``, in ascending job
        index, ``len(codes)`` rows (job-major) of ``codes[r]`` with
        ``auxes[r]`` (an int or an (N,) tensor) at tick ``t``."""
        cap = self._cap(st)
        R = len(codes)
        if R * k > 0 and st.ev_n < cap:
            base = (mask.cumsum(0) - 1) * R + st.ev_n
            for r, (code, aux) in enumerate(zip(codes, auxes)):
                idx = base + r
                idx = torch.where(mask & (idx < cap), idx, cap)
                hdr = torch.stack((self._col(t), self._col(code),
                                   self.job_ids, self._col(aux)), 1)
                st.ev_buf[:, :obs_ring.HEADER_WORDS].index_put_((idx,), hdr)
            st.ev_buf[cap] = 0
        st.ev_n += R * k

    def finishes_by_time(self, st: State, ft: torch.Tensor, k: int) -> None:
        """FINISH rows for the ``k`` jobs whose finish tick ``ft`` is
        below ``_BIG``: by finish tick, ascending index within a tick
        (a stable sort)."""
        r0 = st.ev_n
        st.ev_n += k
        keep = max(0, min(k, self._cap(st) - r0))
        if keep == 0:
            return
        order = torch.sort(ft, stable=True).indices[:keep]
        hdr = torch.stack((ft[order], self._col(obs_schema.FINISH)[:keep],
                           order.to(I32), self._col(-1)[:keep]), 1)
        st.ev_buf[r0:r0 + keep, :obs_ring.HEADER_WORDS] = hdr


def _signal_one(st: State, jobs: Jobs, v: int, te: int, gp: int,
                ring: Optional[_Ring] = None) -> None:
    """Signal preemption of running BE job v (grace period ``gp``, a
    host int) for TE job te; a gang victim promises or vacates all of
    its nodes at once. GP == 0 vacates inline (same tick, requeued on
    top); GP > 0 enters grace and the victim's resources become
    pending."""
    if ring is not None:
        # SIGNAL always; a GP=0 victim vacates and requeues inline (no
        # GRACE_EXPIRE: it never entered grace)
        rows = [(st.t, obs_schema.PREEMPT_SIGNAL, v, te)]
        if gp == 0:
            rows += [(st.t, obs_schema.VACATE, v, te),
                     (st.t, obs_schema.REQUEUE, v, -1)]
        ring.rows(st, rows)
    d = jobs.demand[v][None, :] * st.assign[v][:, None].to(F32)
    st.preempt_count[v] += 1
    st.last_signal[v] = st.t
    st.awaiting_resume[v] = True
    if gp == 0:
        st.state[v] = QUEUED
        st.assign[v] = False
        st.queue_key[v] = st.top_key
        st.top_key -= 1.0
        st.free += d
        st.last_vacate[v] = st.t
    else:
        st.state[v] = GRACE
        st.pending_free += d
        st.grace_left[v] = gp
        st.victim_of[v] = te
        st.te_pending[te] += 1


def _gang_select(st: State, jobs: Jobs, te: int, w: int, rank_val, P,
                 score=None) -> list:
    """Victims for a blocked gang TE (width ``w``), as the JAX engine's
    ``_gang_select`` picks them, in signalling order: a list of
    ``(victim, over_cap)``; the caller signals them and counts each
    over-P-cap one into ``fallback_count``. Pure: nothing is signalled
    here.

    With ``score`` (lower = better victim, over the total gang demand):
    the min-score single victim whose eviction alone yields ``w``
    fitting nodes, among under-P-cap candidates when any exist. Else an
    accumulation in policy order (``rank_val`` higher first, under-cap
    candidates first, the smallest ``jobs.akey`` (else the first index)
    on ties) until ``w`` nodes fit the TE; when even every candidate
    would not suffice, nothing."""
    te_d = jobs.demand[te]
    free0 = st.free
    cand0 = (st.state == RUNNING) & ~jobs.is_te
    under0 = st.preempt_count < P
    if score is not None:
        # single-eviction sufficiency over the (N, nodes, 3) tile
        trial = free0[None, :, :] + jobs.demand[:, None, :] \
            * st.assign[:, :, None].to(F32)
        nfit1 = covers(trial, (te_d - _EPS)[None, None, :]).sum(1)
        pool = cand0 & (under0 | ~(cand0 & under0).any())
        single = pool & (nfit1 >= w)
        v1 = _argmin_key(single, score, jobs.akey)
        have, v1, u1 = _ints(single.any(), v1, _at(under0, v1))
        if have:
            return [(v1, not u1)]
    taken = torch.zeros_like(cand0)
    pending = free0.clone()
    satisfied = _node_fits(pending, te_d).sum() >= w
    picks = []
    while True:
        c = cand0 & ~taken
        m1 = c & under0
        m1_any = m1.any()
        v = _argmax_key(torch.where(m1_any, m1, c), rank_val, jobs.akey)
        sat, c_any, m1_any, v = _ints(satisfied, c.any(), m1_any, v)
        if sat or not c_any:
            return picks if sat else []
        pending += jobs.demand[v][None, :] * st.assign[v][:, None].to(F32)
        satisfied = _node_fits(pending, te_d).sum() >= w
        taken[v] = True
        picks.append((v, not m1_any))


class _Pass(NamedTuple):
    """One fused schedule-pass evaluation shared by the gate, the TE
    lane and the BE lane; ``be_pick``/``be_can``/``nskip`` are host
    values."""
    fits: torch.Tensor       # (N, M) i32
    fit_now: torch.Tensor    # (N,)  i32
    fit_pend: torch.Tensor   # (N,)  i32
    be_pick: int             # BE job the lane would start next (-1: none)
    be_can: bool             # the pick exists and fits now
    nskip: int               # non-fitting queued BE keyed ahead of the
    #                          pick (backfill's scan budget; 0 without)


def _make_step(cfg: SimConfig, jobs: Jobs, n_nodes: int,
               time_mode: str = None, trace: bool = False,
               ext_arrival: Optional[int] = None):
    """Build ``step(State, _Cache)``: one scheduling tick, plus — in
    ``"event"`` time mode — the jump over the following run of provably
    no-op ticks (bit-exact either way). Both arguments are updated in
    place. ``trace`` builds the event emission (the State must then
    carry a ring, ``init_state(trace_capacity=...)``); without it no
    emission code runs. ``ext_arrival`` is a streamed round's boundary
    (:func:`run_round`), folded into every recomputed next arrival.

    Tensors derived from ``jobs`` are taken here, once: a caller that
    writes ``jobs`` in place (the stream engine's pack) builds a new
    step afterwards."""
    dev = jobs.device
    N = jobs.submit.shape[0]
    node_cap = torch.tensor(cfg.cluster.node.as_tuple(), dtype=F32,
                            device=dev)
    time_mode = cfg.time_mode if time_mode is None else time_mode
    if time_mode not in ("tick", "event"):
        raise ValueError(f"unknown time_mode {time_mode!r}; "
                         "one of ('tick', 'event')")
    spec = policy_registry.get_policy(cfg.policy)
    preemptive = spec.preemptive
    P = cfg.max_preemptions
    backfill = cfg.backfill
    depth = min(int(cfg.backfill_depth), N)    # the gate's scan window
    s = torch.tensor(cfg.s, dtype=F32, device=dev)
    gp_f = jobs.gp.to(F32)
    be_job = ~jobs.is_te
    no_jobs = torch.zeros(N, dtype=BOOL, device=dev)
    zero3 = torch.zeros(3, dtype=F32, device=dev)
    # the queue pass scores no candidates: its Eq. 3 normalizers are the
    # clamped empty-mask pair, the same for the whole run
    no_cand_norms = ops.normalizers(jobs.demand, gp_f, no_jobs, node_cap)
    akey = jobs.akey
    arrival_keys = (torch.arange(N, dtype=F32, device=dev) if akey is None
                    else akey)
    ones = torch.ones(N, dtype=I32, device=dev)
    # a gang's score policies rank its victims on their total demand
    total_jobs = dataclasses.replace(
        jobs, demand=jobs.demand * jobs.width[:, None].to(F32))
    # static per-job values the host branches on (no device reads)
    gp_host = jobs.gp.cpu().numpy()
    width_host = jobs.width.cpu().numpy()
    ring = _Ring(n_nodes, N, dev) if trace else None
    # a draw's job ids: the global arrival order (row index, or akey)
    draw_ids = arrival_keys.to(I64)

    def cand_mask(st):
        return (st.state == RUNNING) & be_job

    def head_mask(st):
        q = st.state == QUEUED
        return q & be_job if preemptive else q

    def queue_pass(st: State, be_mask: torch.Tensor) -> _Pass:
        """The fit tile against ``free`` and ``free + pending_free`` and
        the BE queue scan over ``be_mask``, from the fused pass. Without
        backfill the pick is the queue head (head-of-line blocking:
        ``be_can`` is False when the head does not fit); with backfill
        it is the first fitting job in key order, ``nskip`` jobs behind
        the head. (With no pending residue ``free + pending_free``
        equals ``free`` bit for bit, so the JAX engine's residue gate
        needs no twin here.)"""
        ps = ops.schedule_step(jobs.demand, gp_f, jobs.width, st.queue_key,
                               st.assign, st.free, st.pending_free, no_jobs,
                               no_jobs, be_mask, zero3, node_cap, s=s,
                               norms=no_cand_norms)
        if backfill:
            pick, nskip = _ints(ps.be_pick, ps.nskip)
            return _Pass(ps.fits, ps.fit_now, ps.fit_pend, pick, pick >= 0,
                         nskip)
        h = ps.be_head.clamp(min=0)
        can = (ps.be_head >= 0) & (_at(ps.fit_now, h) >= _at(jobs.width, h))
        pick, can = _ints(ps.be_head, can)
        return _Pass(ps.fits, ps.fit_now, ps.fit_pend, pick, bool(can), 0)

    def place(st: State, j: int, nodes: torch.Tensor) -> None:
        """Start job j on the ``nodes`` mask (assumes it fits)."""
        resumed = st.awaiting_resume[j].clone()
        if ring is not None:
            ring.place(st, j, resumed, nodes)
        st.state[j] = RUNNING
        st.assign[j] = nodes
        st.queue_key[j] = _INF
        st.free -= jobs.demand[j][None, :] * nodes[:, None].to(F32)
        st.last_resume[j] = torch.where(resumed, st.t, st.last_resume[j])
        st.awaiting_resume[j] = False

    def first_nodes(row: torch.Tensor, j: int) -> torch.Tensor:
        """The first ``width[j]`` fitting nodes of a fit row."""
        row = row.to(BOOL)
        return row & (row.cumsum(0) <= int(width_host[j]))

    def signal_one(st: State, v: int, te: int) -> None:
        _signal_one(st, jobs, v, te, int(gp_host[v]), ring)

    def score_select(st: State, te: int) -> int:
        """Eq. 2 eligibility (best assigned node), P cap and Eq. 4
        masked argmin, with the paper's random fallback; every
        invocation takes a draw number, and the fallback's uniforms are
        hashed only when it is used."""
        cand = cand_mask(st)
        under = st.preempt_count < P
        if spec.victim_from_pass:
            be_q = (st.state == QUEUED) & be_job
            main = ops.schedule_step(
                jobs.demand, gp_f, jobs.width, st.queue_key, st.assign,
                st.free, st.pending_free, cand, under, be_q, jobs.demand[te],
                node_cap, s=s, akey=akey).victim
            mask_any = main >= 0
        else:
            score = spec.score(jobs, cand, node_cap, s)
            best, _ = _best_victim_node(st.free, st.assign, jobs.demand,
                                        jobs.demand[te])
            mask = cand & (best >= -_EPS) & under
            main = _argmin_key(mask, score, akey)
            mask_any = mask.any()
        count = st.draws
        st.draws += 1
        mask_any, main = _ints(mask_any, main)
        if mask_any:
            return main
        st.fallback_count += 1
        u = job_uniforms(draw_key(st.seed, count), draw_ids)
        return int(_argmax_key(cand, u, akey))

    def until_fits_select(st: State, te: int, rank_val) -> None:
        """LRTP/SRTP/RAND: signal victims (best ``rank_val`` first,
        under-P-cap first) until the TE fits on the last victim's best
        node, counting the demand signalled there so far against the
        free vectors at trigger time."""
        te_d = jobs.demand[te]
        free0 = st.free.clone()
        _, best_node = _best_victim_node(free0, st.assign, jobs.demand, te_d)
        taken = torch.zeros(N, dtype=BOOL, device=dev)
        pending = torch.zeros(n_nodes, 3, dtype=F32, device=dev)
        satisfied = torch.zeros((), dtype=BOOL, device=dev)
        while True:
            cand = cand_mask(st) & ~taken
            m1 = cand & (st.preempt_count < P)
            m1_any = m1.any()
            # two-level pick: under-cap candidates first, then rank
            pick_from = torch.where(m1_any, m1, cand)
            v = _argmax_key(pick_from, rank_val, akey)
            sat, c_any, m1_any, v, node = _ints(
                satisfied, cand.any(), m1_any, v, _at(best_node, v))
            if sat or not c_any:
                return
            st.fallback_count += 1 - m1_any
            signal_one(st, v, te)
            pending[node] += jobs.demand[v]
            satisfied = (te_d <= free0[node] + pending[node] + _EPS).all()
            taken[v] = True

    def gang_score(st: State) -> torch.Tensor:
        """The score policy's Eq. 3-style score over each job's total
        gang demand; fitgpp's from the fused pass (the schedule-pass
        kernel on the card)."""
        cand = cand_mask(st)
        if not spec.victim_from_pass:
            return spec.score(total_jobs, cand, node_cap, s)
        return ops.schedule_step(
            total_jobs.demand, gp_f, jobs.width, st.queue_key, st.assign,
            st.free, st.pending_free, cand, st.preempt_count < P, no_jobs,
            zero3, node_cap, s=s, akey=akey).scores

    def draw(st: State) -> torch.Tensor:
        """One uniform per job at the State's draw count, which
        advances by one."""
        u = job_uniforms(draw_key(st.seed, st.draws), draw_ids)
        st.draws += 1
        return u

    def uniform(st: State):
        """The rank policies' draw (RAND's ranks), taken when called."""
        return lambda: draw(st)

    def trigger_preemption(st: State, te: int) -> None:
        w = int(width_host[te])
        if w == 1:
            if spec.kind == "score":
                signal_one(st, score_select(st, te), te)
            else:
                until_fits_select(st, te, spec.rank(st, jobs, uniform(st)))
            return
        # a gang draws no fallback candidate (RAND's ranks still draw)
        if spec.kind == "score":
            score = gang_score(st)
            picks = _gang_select(st, jobs, te, w, -score, P, score=score)
        else:
            picks = _gang_select(st, jobs, te, w,
                                 spec.rank(st, jobs, uniform(st)), P)
        for v, over_cap in picks:
            st.fallback_count += int(over_cap)
            signal_one(st, v, te)

    def gate(st: State, ps: _Pass) -> bool:
        """Would a pass on this State act? (The lanes' exit evaluation,
        the same verdict as :func:`would_act` for a fresh pass.)"""
        if ps.be_can and (not backfill or ps.nskip < depth):
            return True
        if not preemptive:
            return False
        te_q = (st.state == QUEUED) & jobs.is_te
        trigger = (st.te_pending == 0) & (ps.fit_pend < jobs.width) \
            & cand_mask(st).any()
        return bool((te_q & ((ps.fit_now >= jobs.width) | trigger)).any())

    def would_act(st: State, cache: _Cache) -> bool:
        """Could a schedule pass on this State start a job or invoke
        victim selection? The BE head check gathers one demand row; the
        TE part runs only when a TE is queued. Under backfill the BE
        part asks whether any of the first ``depth`` queued BE jobs in
        key order fits."""
        queued = st.state == QUEUED
        be_q = queued & be_job if preemptive else queued
        fits_now = None
        if backfill:
            fits_now = _gang_fits(st.free, jobs.demand, jobs.width)
            act = _backfill_would_act(be_q, fits_now, st.queue_key, depth)
        else:
            head = _argmin_key(be_q, st.queue_key)
            ok_head = _node_fits(st.free, _at(jobs.demand, head)).sum() \
                >= _at(jobs.width, head)
            act = be_q.any() & ok_head
        if preemptive and cache.n_q_te > 0:
            te_q = queued & jobs.is_te
            if fits_now is None:
                fits_now = _gang_fits(st.free, jobs.demand, jobs.width)
            fits_pend = _gang_fits(st.free + st.pending_free, jobs.demand,
                                   jobs.width)
            trigger = (st.te_pending == 0) & ~fits_pend \
                & cand_mask(st).any()
            act = act | (te_q & (fits_now | trigger)).any()
        return bool(act)

    def te_lane(st: State, ps: _Pass) -> _Pass:
        """Process queued TEs in key order, only the actionable ones
        (fits now, or the preemption trigger is armed); every
        non-actionable TE ahead of the next actionable one is skipped
        wholesale. Every action refreshes the shared pass."""
        processed = torch.zeros(N, dtype=BOOL, device=dev)
        while True:
            q = (st.state == QUEUED) & jobs.is_te & ~processed
            has_cand = cand_mask(st).any()
            trigger = (st.te_pending == 0) & (ps.fit_pend < jobs.width) \
                & has_cand
            can = q & ((ps.fit_now >= jobs.width) | trigger)
            jt = _argmin_key(can, st.queue_key)
            wj = _at(jobs.width, jt)
            any_can, j, ok, fits_pend, te_free, has_cand = _ints(
                can.any(), jt, _at(ps.fit_now, jt) >= wj,
                _at(ps.fit_pend, jt) >= wj, _at(st.te_pending, jt) == 0,
                has_cand)
            if not any_can:
                return ps
            # everything queued ahead of j is non-actionable
            processed |= q & (st.queue_key <= st.queue_key[j])
            if ok:
                place(st, j, first_nodes(ps.fits[j], j))
            elif te_free and not fits_pend and has_cand:
                trigger_preemption(st, j)
                # GP=0 victims vacate inline: place the TE now, before
                # the BE lane can reclaim the freed nodes
                ok2, nodes = _gang_fit(st.free, jobs.demand[j],
                                       int(width_host[j]))
                if bool(ok2):
                    place(st, j, nodes)
            ps = queue_pass(st, head_mask(st))

    def be_queue(st: State, ps: _Pass) -> _Pass:
        """FIFO head-of-line BE lane: place the head while it fits."""
        while ps.be_can:
            j = ps.be_pick
            place(st, j, first_nodes(ps.fits[j], j))
            ps = queue_pass(st, head_mask(st))
        return ps

    def be_queue_backfill(st: State, ps: _Pass) -> _Pass:
        """Bounded first-fit backfill: walk the BE queue in key order,
        start whatever fits, skip (at most ``backfill_depth`` in all)
        whatever does not; skipped jobs keep their keys and are not
        revisited this pass. Each iteration places the pass's pick, once
        the ``nskip`` jobs ahead of it still fit the budget, and marks
        those skips in bulk. Returns a pass over the full queue (the
        gate's view)."""
        skipped = torch.zeros(N, dtype=BOOL, device=dev)
        scanned = 0
        while ps.be_can and scanned + ps.nskip < cfg.backfill_depth:
            j = ps.be_pick
            q = head_mask(st) & ~skipped
            skipped |= q & (ps.fit_now < jobs.width) \
                & (st.queue_key < st.queue_key[j])
            scanned += ps.nskip
            place(st, j, first_nodes(ps.fits[j], j))
            if ring is not None and scanned > 0:
                # marker after a placement that skipped ahead; aux =
                # the pass's cumulative skips
                ring.rows(st, [(st.t, obs_schema.BACKFILL, j, scanned)])
            ps = queue_pass(st, head_mask(st) & ~skipped)
        return queue_pass(st, head_mask(st))

    def arrivals(st: State, cache: _Cache) -> None:
        """Queue every submitted job, keyed by arrival order (row index,
        or ``jobs.akey``), when the cached next arrival is due."""
        if cache.next_arrival > st.t:
            return
        arrive = (jobs.submit <= st.t) & (st.state == NOT_ARRIVED)
        st.state.masked_fill_(arrive, QUEUED)
        st.queue_key = torch.where(arrive, arrival_keys, st.queue_key)
        nxt = torch.where(st.state == NOT_ARRIVED, jobs.submit, _BIG).min()
        nxt, n_te, n_all = _ints(nxt, (arrive & jobs.is_te).sum(),
                                 arrive.sum())
        if ext_arrival is not None:
            nxt = min(nxt, int(ext_arrival))
        if ring is not None:
            ring.masked(st, arrive, n_all, st.t, (obs_schema.SUBMIT,),
                        (-1,))
        cache.next_arrival = nxt
        cache.n_q_te += n_te
        cache.n_queued += n_all

    def vacates(st: State, cache: _Cache) -> None:
        """Vacate grace-expired victims: requeue on top, FIFO among
        same-tick vacates in arrival order (job index, or ``jobs.akey``:
        a sort over the vacating rows gives the ranks JAX counts by
        comparison)."""
        if cache.next_vacate > st.t:
            return
        vac = (st.state == GRACE) & (st.grace_left <= 0)
        if akey is None:
            rank = vac.cumsum(0) - 1
        else:
            rank = torch.where(vac, akey, _INF).argsort().argsort()
        te_dec = torch.zeros(N + 1, dtype=I32, device=dev).scatter_add_(
            0, torch.where(vac, st.victim_of, N).long(), ones)[:N]
        freed = _release(st.assign, jobs.demand, vac)
        if ring is not None:
            # the VACATE row's aux, read before victim_of is cleared
            vac_te = torch.where(vac, st.victim_of, -1)
        st.queue_key = torch.where(vac, st.top_key - rank.to(F32),
                                   st.queue_key)
        st.free += freed
        st.pending_free -= freed
        st.last_vacate.masked_fill_(vac, st.t)
        st.te_pending -= te_dec
        st.victim_of.masked_fill_(vac, -1)
        st.assign &= ~vac[:, None]
        st.state.masked_fill_(vac, QUEUED)
        any_g, g = _next_vacate(st)
        n_vac, any_g, g = _ints(vac.sum(), any_g, g)
        if ring is not None:
            # [GRACE_EXPIRE, VACATE(aux = te), REQUEUE] per job,
            # job-major in index order (grace jobs all have GP > 0)
            ring.masked(st, vac, n_vac, st.t,
                        (obs_schema.GRACE_EXPIRE, obs_schema.VACATE,
                         obs_schema.REQUEUE), (-1, vac_te, -1))
        st.top_key -= n_vac
        cache.next_vacate = st.t + g if any_g else _BIG
        cache.n_queued += n_vac

    def schedule(st: State, cache: _Cache) -> bool:
        """The full schedule pass and cache refresh; returns the gate
        verdict of the lanes' exit pass."""
        ps = queue_pass(st, head_mask(st))
        if preemptive:
            ps = te_lane(st, ps)
        ps = be_queue_backfill(st, ps) if backfill else be_queue(st, ps)
        queued = st.state == QUEUED
        any_g, g = _next_vacate(st)
        any_g, g, n_q_te, n_queued = _ints(
            any_g, g, (queued & jobs.is_te).sum(), queued.sum())
        cache.next_vacate = st.t + g if any_g else _BIG
        cache.n_q_te = n_q_te
        cache.n_queued = n_queued
        return gate(st, ps)

    def run_minute(st: State, cache: _Cache) -> int:
        """Decrement running clocks, retire finishers, count grace
        down. The finishers retire in one bulk update: with the integer
        demands of the paper's workloads the free-vector sums are exact
        in any order, so this equals the reference's per-job loop."""
        running = st.state == RUNNING
        st.remaining -= running.to(I32)
        fin = running & (st.remaining <= 0)
        nfin = int(fin.sum())
        if nfin > 0:
            if ring is not None:
                ring.masked(st, fin, nfin, st.t + 1, (obs_schema.FINISH,),
                            (-1,))
            st.state.masked_fill_(fin, DONE)
            st.finish.masked_fill_(fin, st.t + 1)
            st.free += _release(st.assign, jobs.demand, fin)
            st.assign &= ~fin[:, None]
            st.n_done += nfin
        if cache.next_vacate < _BIG:
            st.grace_left -= (st.state == GRACE).to(I32)
        st.t += 1
        return nfin

    def jump(st: State, cache: _Cache) -> None:
        """Advance to the next event in one step (next arrival, grace
        expiry or finish), bulk-decrementing the clocks; with nothing
        queued, drain: jump to the next arrival or vacate and retire
        every finisher on the way. No events at all -> ``MAX_TICKS``."""
        t1 = st.t
        running = st.state == RUNNING
        in_grace = st.state == GRACE
        d_ev = min(cache.next_arrival - t1, cache.next_vacate - t1)
        span = max(MAX_TICKS - t1, 0)
        if cache.n_queued == 0:
            last_fin = int(torch.where(running, st.remaining, 0).max())
            dt = last_fin if d_ev >= _BIG - t1 else min(max(d_ev, 0), span)
            fin = running & (st.remaining <= dt)
            nfin = int(fin.sum())
            if ring is not None:
                # the FINISH rows the skipped ticks would have emitted
                ring.finishes_by_time(
                    st, torch.where(fin, t1 + st.remaining, _BIG), nfin)
            st.finish = torch.where(fin, t1 + st.remaining, st.finish)
            st.remaining -= torch.where(fin, st.remaining,
                                        dt * running.to(I32))
            st.state.masked_fill_(fin, DONE)
            st.free += _release(st.assign, jobs.demand, fin)
            st.assign &= ~fin[:, None]
            st.n_done += nfin
        else:
            d_fin = int(torch.where(running, st.remaining - 1,
                                    MAX_TICKS).min())
            dt = min(max(min(d_ev, d_fin), 0), span)
            st.remaining -= dt * running.to(I32)
        st.grace_left -= dt * in_grace.to(I32)
        st.t = t1 + dt

    def step(st: State, cache: _Cache) -> bool:
        """One tick (and the event jump); True when its schedule pass
        ran (an acting tick)."""
        arrivals(st, cache)
        vacates(st, cache)
        # every schedule action starts from a queued job
        act = cache.n_queued > 0 and would_act(st, cache)
        act_next = schedule(st, cache) if act else False
        nfin = run_minute(st, cache)
        if time_mode == "tick":
            return act
        # finishers freed capacity: re-evaluate the gate; otherwise the
        # lanes' exit evaluation still answers for this State
        if nfin > 0:
            hold = cache.n_queued > 0 and would_act(st, cache)
        else:
            hold = act_next
        if not (st.n_done >= N or hold):
            jump(st, cache)
        return act

    return step


def make_tick(cfg: SimConfig, jobs: Jobs, n_nodes: int,
              time_mode: str = None, trace: bool = False):
    """A ``State -> State`` step (one tick, or one tick plus the event
    jump); the cache is rebuilt from the State on every call, so
    single-stepping equals :func:`run`'s loop. With ``trace`` the State
    must carry a ring."""
    step = _make_step(cfg, jobs, n_nodes, time_mode=time_mode, trace=trace)

    def tick_step(st: State) -> State:
        if trace and st.ev_buf.numel() == 0:
            raise ValueError("a traced step needs a State with a ring "
                             "(init_state(trace_capacity=...))")
        step(st, _cache_from_state(jobs, st))
        return st

    return tick_step


def resolve_trace_capacity(cfg: SimConfig, jobs: Jobs,
                           trace_capacity=None) -> int:
    """The ring capacity a traced run uses: ``trace_capacity`` when
    given, else ``obs.ring.default_capacity`` sized from the jobs and
    the config's P cap (as the JAX engine sizes it)."""
    if trace_capacity is not None:
        return int(trace_capacity)
    return obs_ring.default_capacity(jobs.submit.shape[0],
                                     cfg.max_preemptions)


def run(cfg: SimConfig, jobs: Jobs, seed: int = 0,
        time_mode: Optional[str] = None,
        stats: Optional[dict] = None, trace: bool = False,
        trace_capacity: Optional[int] = None) -> State:
    """Run the full simulation on the jobs' device; returns the final
    State. ``stats``, when given, receives the loop's ``iterations``
    and ``acting_ticks`` (the ticks whose schedule pass ran). ``trace``
    records every scheduler event into the State's ring
    (:func:`resolve_trace_capacity` rows; decode with
    :func:`decode_trace`); off, the ring is zero-size."""
    cap = resolve_trace_capacity(cfg, jobs, trace_capacity) if trace else 0
    if trace and cap <= 0:
        raise ValueError(f"trace_capacity must be > 0, got {cap}")
    st = init_state(jobs, cfg.cluster.n_nodes, cfg.cluster.node.as_tuple(),
                    seed, trace_capacity=cap)
    step = _make_step(cfg, jobs, cfg.cluster.n_nodes, time_mode=time_mode,
                      trace=trace)
    cache = _cache_from_state(jobs, st)
    N = jobs.submit.shape[0]
    iterations = acting = 0
    while st.n_done < N and st.t < MAX_TICKS:
        acting += step(st, cache)
        iterations += 1
    if stats is not None:
        stats["iterations"] = iterations
        stats["acting_ticks"] = acting
    return st


def run_round(cfg: SimConfig, jobs: Jobs, st: State,
              round_end: Optional[int] = None,
              time_mode: Optional[str] = None, trace: bool = False,
              stats: Optional[dict] = None) -> State:
    """Resume an in-flight State for one streamed macro-round (the
    counterpart of ``sim_jax.run_round``): run the loop until every job
    of ``jobs`` is DONE or ``st.t`` reaches ``round_end``, the submit
    tick of the earliest job not in ``jobs`` yet (None: no more
    arrivals, run to the end). That tick is not executed: the next
    round's first iteration runs it with the new arrivals in. ``jobs``
    is the stream engine's slot pool, with ``Jobs.akey`` stamped in
    global arrival order. ``stats``, when given, has ``iterations`` and
    ``acting_ticks`` added to."""
    step = _make_step(cfg, jobs, cfg.cluster.n_nodes, time_mode=time_mode,
                      trace=trace, ext_arrival=round_end)
    cache = _cache_from_state(jobs, st, round_end)
    N = jobs.submit.shape[0]
    end = MAX_TICKS if round_end is None else min(int(round_end), MAX_TICKS)
    iterations = acting = 0
    while st.n_done < N and st.t < end:
        acting += step(st, cache)
        iterations += 1
    if stats is not None:
        stats["iterations"] = stats.get("iterations", 0) + iterations
        stats["acting_ticks"] = stats.get("acting_ticks", 0) + acting
    return st


def trace_overflow(st: State) -> int:
    """Ring rows dropped past capacity (0 with tracing off); non-zero
    means the trace is truncated."""
    if st.ev_buf.numel() == 0:
        return 0
    return max(st.ev_n - (st.ev_buf.shape[0] - 1), 0)


def decode_trace(st: State):
    """The State's ring as ``(list[obs.schema.Event], overflow)`` (read
    to the host once); ``([], 0)`` for an untraced State."""
    if st.ev_buf.numel() == 0:
        return [], 0
    return obs_ring.decode_ring(st.ev_buf, st.ev_n)


def slowdown(jobs: Jobs, st: State) -> torch.Tensor:
    """Eq. 5: 1 + waiting / execution, float32."""
    waiting = st.finish - jobs.submit - jobs.exec_total
    return 1.0 + waiting / jobs.exec_total


def masked_percentile_rows(vals: torch.Tensor, mask: torch.Tensor,
                           ps) -> torch.Tensor:
    """(..., len(ps)) float32: per row of the last axis, the
    percentiles ``ps`` of ``vals[mask]``, linear interpolation computed
    in float32 as JAX's compiled ``nanpercentile`` computes it on the
    CPU (so the two agree to the last bit); ``nan`` in a row whose mask
    is empty."""
    v = torch.sort(torch.where(mask, vals.to(F32), _INF), -1).values
    n = mask.sum(-1, keepdim=True)
    # p * 0.01, not p / 100: the JAX version's compiled ``q / 100``
    # multiplies by the float32 reciprocal (p99 -> 0.98999995)
    q = torch.tensor(list(ps), dtype=F32, device=v.device) * 0.01
    pos = q * (n - 1).to(F32)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    top = (n - 1).clamp(min=0).to(F32)
    lo = torch.minimum(low, top).clamp(min=0).long()
    hi = torch.minimum(high, top).clamp(min=0).long()
    # XLA contracts ``low * low_w + high * high_w`` into one fused
    # multiply-add of the high term onto the rounded low term; a
    # float64 product of two float32 values is exact, so the sum in
    # float64 rounded once to float32 is that FMA
    low_term = v.gather(-1, lo) * low_w
    out = (v.gather(-1, hi).double() * high_w.double()
           + low_term.double()).to(F32)
    return torch.where(n > 0, out, float("nan"))


def masked_percentiles(vals: torch.Tensor, mask: torch.Tensor,
                       ps) -> dict:
    """``{f"p{p}": percentile of vals[mask]}`` for 1-D ``vals`` (host
    floats, :func:`masked_percentile_rows`); an explicit ``nan`` for
    every entry when the mask is empty."""
    out = masked_percentile_rows(vals, mask, ps).tolist()
    return {f"p{p}": x for p, x in zip(ps, out)}


def result_summary(jobs: Jobs, st: State) -> dict:
    """Percentile summary mirroring the JAX ``result_summary``: TE/BE
    slowdown p50/p95/p99, the preempted BE fraction, the preemption to
    resume intervals, the fallback counter and the ring's overflow
    (host numbers)."""
    sd = slowdown(jobs, st)
    te = jobs.is_te & jobs.valid
    be = ~jobs.is_te & jobs.valid
    out = {name: masked_percentiles(sd, m, (50, 95, 99))
           for name, m in (("TE", te), ("BE", be))}
    out["preempted_frac"] = (float((st.preempt_count[be] > 0)
                                   .to(F32).mean())
                             if bool(be.any()) else float("nan"))
    iv_mask = (st.last_resume >= 0) & jobs.valid
    out["intervals"] = masked_percentiles(
        (st.last_resume - st.last_signal).to(F32), iv_mask,
        (50, 75, 95, 99))
    out["fallback_count"] = st.fallback_count
    out["trace_overflow"] = trace_overflow(st)
    return out

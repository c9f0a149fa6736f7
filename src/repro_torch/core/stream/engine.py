"""StreamEngine: bounded-memory replay of arbitrarily long traces.

The port of the JAX package's ``core/stream/engine.py``. A fixed pool of
``capacity`` job slots of ``sim_torch`` state (O(capacity x nodes)
device memory) is driven by a host loop that alternates

  1. *pack*: pull the next arrivals from a :class:`JobSource` and write
     them into recycled DONE slots in place (:func:`_pack`), stamping
     each job's global sequence number into ``Jobs.akey`` so queue keys,
     requeue ranks and victim tie-breaks keep the global arrival order
     whatever slot a job lands in;
  2. *run*: one macro-round (``sim_torch.run_round``), the engine's
     tick/event loop and its fused schedule pass (the CUDA kernel on
     the card), until every pool job is DONE or ``t`` reaches the round
     boundary: the earliest submit not packed yet, folded into the
     loop's next-arrival cache so no event jump passes it;
  3. *drain*: decode the round's event ring (sized off the capacity,
     ``obs.ring.round_capacity``), remap slot ids to global job ids and
     hand events and finished jobs' results out (callback sinks or
     accumulation).

The State (``t``, ``top_key``, the free vectors, ``fallback_count``, the
draw count, the live rows) carries across rounds untouched, so a
streamed run equals the monolithic engine on the same workload job for
job (:func:`verify_prefix_parity`), random draws included: a draw
hashes each job's global sequence number (``Jobs.akey``), not its slot,
so a score policy's fallback victim and RAND's ranks are the monolithic
run's whatever the pool size, and the draw count is compared for every
policy (as the JAX package compares its key).

A slot is recyclable when its job is DONE and no in-grace victim still
references it (``victim_of`` points at TE slots; a vacate decrements
``te_pending`` there). When the pool is full and an unpacked arrival is
overdue, the overdue jobs spill to a host FIFO (:class:`_SpillQueue`,
order kept) and rounds shrink to one tick until slots free up. A spilled
job is packed later than it arrived, which leaves the parity domain:
``n_spilled`` is on the result and :func:`verify_prefix_parity` refuses
such runs.

Closed-loop arrivals (``admission=``): the source is wrapped in
``admission.ClosedLoopAdmission``, which re-stamps closed-loop admit
ticks (paper §4.2, load 2.0) in bounded memory
(:func:`verify_closed_loop_parity`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.cluster import SimConfig
from repro_torch.core import sim_torch, workload
from repro_torch.core.stream.source import _FIELDS, JobSource, materialize
from repro_torch.core.types import DONE, GRACE, NOT_ARRIVED, JobSet
from repro_torch.obs import ring as obs_ring
from repro_torch.obs import schema as obs_schema

# Default pool size: K slots per (node x preemption-budget) unit, enough
# for the queue depths the repo's open-loop loads produce.
DEFAULT_SLOTS_PER_NODE = 32

# ``Jobs.akey`` carries the global sequence number as float32, exact up
# to 2^24: the next gid would round onto the previous one and break the
# global arrival order of queue keys and tie-breaks. Packing past this
# limit raises.
AKEY_GID_LIMIT = 1 << 24

# aux carries a TE job id (not a count) on these codes: remapped
# slot -> gid at drain time like the job column
_AUX_JOB_CODES = (obs_schema.PREEMPT_SIGNAL, obs_schema.VACATE)

_RESULT_COLS = ("submit", "exec_total", "is_te", "width", "finish",
                "preempt_count", "last_signal", "last_vacate",
                "last_resume")
# the per-slot State rows one host read per round brings back: the pack
# needs state and victim_of, the harvest the rest
_READ_ROWS = ("state", "victim_of", "finish", "preempt_count",
              "last_signal", "last_vacate", "last_resume")
_I32, _F32 = torch.int32, torch.float32


def default_capacity(cfg: SimConfig, P: Optional[int] = None) -> int:
    P = cfg.max_preemptions if P is None else P
    return max(64, DEFAULT_SLOTS_PER_NODE * cfg.cluster.n_nodes
               * max(int(P), 1))


def _empty_pool(capacity: int, dev: torch.device) -> sim_torch.Jobs:
    """An all-sentinel pool: every slot invalid (born DONE), ready to be
    recycled by the first pack."""
    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return sim_torch.Jobs(
        submit=full((capacity,), 0, _I32),
        exec_total=full((capacity,), 1, _I32),
        demand=full((capacity, 3), 0.0, _F32),
        is_te=full((capacity,), False, torch.bool),
        gp=full((capacity,), 0, _I32),
        width=full((capacity,), 1, _I32),
        valid=full((capacity,), False, torch.bool),
        akey=full((capacity,), float("inf"), _F32))


def _pack(jobs: sim_torch.Jobs, st: sim_torch.State, slots: torch.Tensor,
          ints: torch.Tensor, floats: torch.Tensor) -> None:
    """Write a chunk into the DONE slots ``slots`` (int64), in place,
    resetting every per-slot State field the previous tenant touched.
    ``ints`` is (n, 5) int32: submit, exec_total, gp, width, is_te;
    ``floats`` (n, 4) float32: demand and akey. The recycled slots were
    DONE, so un-DONE-ing n of them is the only ``n_done`` change."""
    exec_total = ints[:, 1]
    jobs.submit.index_copy_(0, slots, ints[:, 0])
    jobs.exec_total.index_copy_(0, slots, exec_total)
    jobs.gp.index_copy_(0, slots, ints[:, 2])
    jobs.width.index_copy_(0, slots, ints[:, 3])
    jobs.is_te.index_copy_(0, slots, ints[:, 4].bool())
    jobs.demand.index_copy_(0, slots, floats[:, :3])
    jobs.akey.index_copy_(0, slots, floats[:, 3])
    jobs.valid.index_fill_(0, slots, True)
    st.state.index_fill_(0, slots, NOT_ARRIVED)
    st.remaining.index_copy_(0, slots, exec_total)
    st.assign.index_fill_(0, slots, False)
    for name, value in (("preempt_count", 0), ("grace_left", 0),
                        ("queue_key", float("inf")), ("finish", -1),
                        ("te_pending", 0), ("victim_of", -1),
                        ("last_signal", -1), ("last_vacate", -1),
                        ("last_resume", -1), ("awaiting_resume", False)):
        getattr(st, name).index_fill_(0, slots, value)
    st.n_done -= int(slots.shape[0])


class _SpillQueue:
    """Host FIFO for arrivals that are due while every slot is occupied:
    jobs move here from the source in stream order and are packed back
    out spill-first, so the global arrival order (the gid sequence) is
    kept. ``n`` is the current depth, ``peak``/``total`` the high-water
    mark and the lifetime spill count on :class:`StreamResult`."""

    def __init__(self):
        self._chunks: List[JobSet] = []
        self._off = 0
        self.n = 0
        self.peak = 0
        self.total = 0

    def push(self, js: JobSet) -> None:
        self._chunks.append(js)
        self.n += js.n
        self.total += js.n
        self.peak = max(self.peak, self.n)

    def peek_submit(self) -> Optional[int]:
        if not self._chunks:
            return None
        return int(self._chunks[0].submit[self._off])

    def take(self, k: int) -> Optional[JobSet]:
        parts: List[tuple] = []
        got = 0
        while got < k and self._chunks:
            js = self._chunks[0]
            n = min(k - got, js.n - self._off)
            parts.append((js, self._off, self._off + n))
            self._off += n
            got += n
            if self._off == js.n:
                self._chunks.pop(0)
                self._off = 0
        if got == 0:
            return None
        self.n -= got
        return JobSet(**{
            f: np.concatenate([getattr(js, f)[a:b] for js, a, b in parts])
            for f in _FIELDS})


def _np_masked_percentiles(vals, mask, ps) -> Dict[str, float]:
    """Percentiles of ``vals[mask]`` by numpy's linear interpolation;
    ``nan`` for every entry when the mask is empty."""
    if not mask.any():
        return {f"p{p}": float("nan") for p in ps}
    v = np.where(mask, vals, np.nan).astype(np.float64)
    return {f"p{p}": float(np.nanpercentile(v, p)) for p in ps}


@dataclass
class StreamResult:
    """Per-job results of a streamed replay, in gid order (gid = global
    arrival sequence number). ``summary()`` mirrors
    ``sim_torch.result_summary``. ``events`` is the remapped event
    stream when tracing without an ``event_sink``, else None.
    ``final_draws`` is the engine's draw count at the end;
    ``iterations`` and ``acting_ticks`` add up the rounds' loops."""
    n_jobs: int
    capacity: int
    rounds: int
    makespan: int
    fallback_count: int
    trace_overflow: int
    max_live: int
    final_draws: int
    submit: np.ndarray = field(repr=False)
    exec_total: np.ndarray = field(repr=False)
    is_te: np.ndarray = field(repr=False)
    width: np.ndarray = field(repr=False)
    finish: np.ndarray = field(repr=False)
    preempt_count: np.ndarray = field(repr=False)
    last_signal: np.ndarray = field(repr=False)
    last_vacate: np.ndarray = field(repr=False)
    last_resume: np.ndarray = field(repr=False)
    events: Optional[List] = field(repr=False, default=None)
    # jobs that were due while the pool was full and waited in the host
    # spill queue (lifetime count / high-water depth); nonzero means the
    # run left the parity domain
    n_spilled: int = 0
    spill_peak: int = 0
    iterations: int = 0
    acting_ticks: int = 0

    def slowdown(self) -> np.ndarray:
        waiting = self.finish - self.submit - self.exec_total
        return 1.0 + waiting / self.exec_total

    def summary(self) -> dict:
        sd = self.slowdown()
        te, be = self.is_te, ~self.is_te
        out = {"TE": _np_masked_percentiles(sd, te, (50, 95, 99)),
               "BE": _np_masked_percentiles(sd, be, (50, 95, 99))}
        out["preempted_frac"] = (
            float((self.preempt_count[be] > 0).mean()) if be.any()
            else float("nan"))
        iv = (self.last_resume - self.last_signal).astype(np.float64)
        out["intervals"] = _np_masked_percentiles(
            iv, self.last_resume >= 0, (50, 75, 95, 99))
        out["fallback_count"] = self.fallback_count
        out["trace_overflow"] = self.trace_overflow
        out["n_spilled"] = self.n_spilled
        return out


class StreamEngine:
    """Host driver of the macro-round loop (module docstring), on
    ``device`` (the current CUDA device unless the caller passes one,
    e.g. ``device="cpu"``).

    ``event_sink`` / ``result_sink``: optional per-round callbacks
    (``sink(list_of_events)`` / ``sink(dict_of_np_arrays)``). With a
    sink that stream is not accumulated: O(capacity) memory end to end;
    without one, results (a few scalars a job) and traced events are
    collected into the result.

    ``admission``: closed-loop arrivals (paper §4.2). A float is the
    FIFO-normalized backlog target, ``True`` uses ``cfg.workload.load``;
    the source's submit times are replaced by closed-loop admit ticks
    (``admission.ClosedLoopAdmission``), bit-exact with the monolithic
    ``workload.closed_loop_submit_times``. ``None``/``0`` keeps the
    open-loop path.
    """

    def __init__(self, cfg: SimConfig, source: JobSource,
                 capacity: Optional[int] = None,
                 time_mode: Optional[str] = None,
                 trace: bool = False,
                 trace_capacity: Optional[int] = None,
                 event_sink: Optional[Callable] = None,
                 result_sink: Optional[Callable] = None,
                 admission=None, device=None):
        self.cfg = cfg
        self.device = _device.resolve(device)
        self.admission: Optional[float] = None
        if admission:
            from repro_torch.core.stream.admission import ClosedLoopAdmission
            target = (cfg.workload.load if admission is True
                      else float(admission))
            self.admission = target
            source = JobSource(
                ClosedLoopAdmission(cfg, source, target=target))
        self.source = source
        self.capacity = int(capacity if capacity is not None
                            else default_capacity(cfg))
        self.time_mode = cfg.time_mode if time_mode is None else time_mode
        self.trace = bool(trace)
        self.trace_capacity = (
            int(trace_capacity) if trace_capacity is not None
            else obs_ring.round_capacity(self.capacity,
                                         cfg.max_preemptions))
        self.event_sink = event_sink
        self.result_sink = result_sink

    # -- host-side round phases --------------------------------------

    def _reset(self) -> None:
        """Fresh per-run host state (a method of its own so that tests
        can interpose, e.g. forge ``_n_seen`` to reach the akey limit
        without packing 2^24 jobs)."""
        cap = self.capacity
        self._slot_gid = np.full(cap, -1, np.int64)
        self._harvested = np.zeros(cap, bool)
        # host copies of the pool's job columns the harvest reports
        self._pool = {"submit": np.zeros(cap, np.int64),
                      "exec_total": np.ones(cap, np.int64),
                      "is_te": np.zeros(cap, bool),
                      "width": np.ones(cap, np.int64),
                      "valid": np.zeros(cap, bool)}
        self._n_seen = 0
        self._overflow = 0
        self._events: List = []
        self._batches: List[dict] = []
        self._spill = _SpillQueue()
        self._loop_stats: Dict[str, int] = {}

    def _take_arrivals(self, k: int) -> Optional[JobSet]:
        """Pull up to ``k`` jobs, spill queue first: spilled jobs arrived
        before anything still in the source."""
        parts: List[JobSet] = []
        got = 0
        js = self._spill.take(k)
        if js is not None:
            parts.append(js)
            got = js.n
        if got < k:
            js = self.source.take(k - got)
            if js is not None:
                parts.append(js)
        if not parts:
            return None
        if len(parts) == 1:
            return parts[0]
        return JobSet(**{
            f: np.concatenate([getattr(js, f) for js in parts])
            for f in _FIELDS})

    def _pack_round(self, jobs, st, rows_h):
        """Recycle free slots with the next arrivals (spill queue first);
        returns the round boundary (the next unpacked submit, or None).
        ``rows_h`` is this round's host read (:data:`_READ_ROWS`)."""
        cap = self.capacity
        state_h, victim_h = rows_h[0], rows_h[1]
        # a DONE TE slot referenced by an in-grace victim is not
        # recyclable: its vacate still decrements te_pending there
        ref = np.zeros(cap, bool)
        vo = victim_h[state_h == GRACE]
        ref[vo[vo >= 0]] = True
        free = np.flatnonzero((state_h == DONE) & ~ref)
        n_packed = 0
        if free.size:
            js = self._take_arrivals(int(free.size))
            if js is not None:
                n_packed = js.n
                if self._n_seen + n_packed > AKEY_GID_LIMIT:
                    raise RuntimeError(
                        f"stream gid would pass {AKEY_GID_LIMIT} (2^24), "
                        "the float32 akey exact-integer limit: queue keys "
                        "would collide and global arrival order would "
                        "break. Split the replay at this boundary.")
                slots = free[:n_packed]
                gids = np.arange(self._n_seen, self._n_seen + n_packed,
                                 dtype=np.int64)
                ints = np.stack([js.submit, js.exec_total, js.gp,
                                 js.n_nodes, js.is_te], 1).astype(np.int32)
                floats = np.concatenate(
                    [np.asarray(js.demand, np.float32),
                     gids.astype(np.float32)[:, None]], 1)
                dev = self.device
                _pack(jobs, st, torch.from_numpy(slots).to(dev),
                      torch.from_numpy(ints).to(dev),
                      torch.from_numpy(floats).to(dev))
                pool = self._pool
                pool["submit"][slots] = js.submit
                pool["exec_total"][slots] = js.exec_total
                pool["is_te"][slots] = js.is_te
                pool["width"][slots] = js.n_nodes
                pool["valid"][slots] = True
                self._slot_gid[slots] = gids
                self._harvested[slots] = False
                self._n_seen += n_packed
        nxt = self._spill.peek_submit()
        if nxt is None:
            nxt = self.source.peek_submit()
        if nxt is not None and nxt <= st.t and free.size - n_packed == 0:
            # saturated: arrivals are overdue and every slot is busy.
            # Move the whole due prefix to the spill queue (stream order
            # kept) and shrink the round to one tick, so the next pack
            # sees freshly freed slots as soon as possible.
            moved = self.source.take_due(st.t)
            if moved is not None:
                self._spill.push(moved)
            nxt = st.t + 1
        return nxt

    def _drain_events(self, st) -> None:
        """Decode and slot -> gid remap this round's ring rows, then
        clear them and reset ``ev_n`` for the next round. Only the rows
        written are read back."""
        if not self.trace:
            return
        cap = st.ev_buf.shape[0] - 1
        kept = min(st.ev_n, cap)
        rows = st.ev_buf if st.ev_n > cap else st.ev_buf[:kept + 1]
        events, overflow = obs_ring.decode_ring(rows, st.ev_n)
        self._overflow += int(overflow)
        gid = self._slot_gid
        remapped = [
            obs_schema.Event(
                t=e.t, code=e.code, job=int(gid[e.job]),
                aux=(int(gid[e.aux])
                     if e.code in _AUX_JOB_CODES and e.aux >= 0
                     else e.aux),
                nodes=e.nodes)
            for e in events]
        if self.event_sink is not None:
            self.event_sink(remapped)
        else:
            self._events.extend(remapped)
        st.ev_buf[:kept].zero_()
        st.ev_n = 0

    def _harvest(self, rows_h) -> int:
        """Collect per-job results of newly finished slots."""
        done = (rows_h[0] == DONE) & self._pool["valid"] & ~self._harvested
        idx = np.flatnonzero(done)
        if idx.size == 0:
            return 0
        self._harvested[idx] = True
        batch = {"gid": self._slot_gid[idx]}
        for k in ("submit", "exec_total", "is_te", "width"):
            batch[k] = self._pool[k][idx]
        for r, k in enumerate(_READ_ROWS[2:], 2):
            batch[k] = rows_h[r][idx].astype(np.int64)
        if self.result_sink is not None:
            self.result_sink(batch)
        else:
            self._batches.append(batch)
        return idx.size

    @staticmethod
    def _read(st) -> np.ndarray:
        """The State rows of :data:`_READ_ROWS`, in one host read."""
        return torch.stack([getattr(st, k) for k in _READ_ROWS]) \
            .cpu().numpy()

    # -- the macro-round loop ----------------------------------------

    def run(self) -> StreamResult:
        cfg, cap = self.cfg, self.capacity
        jobs = _empty_pool(cap, self.device)
        st = sim_torch.init_state(
            jobs, cfg.cluster.n_nodes, cfg.cluster.node.as_tuple(),
            cfg.seed, trace_capacity=self.trace_capacity if self.trace else 0)
        self._reset()
        rounds, n_done, max_live = 0, 0, 0
        rows_h = self._read(st)
        while True:
            nxt = self._pack_round(jobs, st, rows_h)
            live = cap - st.n_done
            max_live = max(max_live, live)
            if live == 0 and nxt is None:
                break                     # drained: nothing left anywhere
            before = (st.t, n_done, self._n_seen)
            sim_torch.run_round(cfg, jobs, st, round_end=nxt,
                                time_mode=self.time_mode, trace=self.trace,
                                stats=self._loop_stats)
            rounds += 1
            if st.t >= sim_torch.MAX_TICKS:
                raise RuntimeError(
                    f"streamed run stalled: t reached the "
                    f"{sim_torch.MAX_TICKS}-tick terminal with jobs "
                    "unfinished")
            self._drain_events(st)
            rows_h = self._read(st)
            n_done += self._harvest(rows_h)
            if (st.t, n_done, self._n_seen) == before:
                raise RuntimeError(
                    "streamed run made no progress in a round "
                    f"(t={st.t}, done={n_done}): engine fault")
        return self._finalize(st, rounds, n_done, max_live)

    def _finalize(self, st, rounds, n_done, max_live) -> StreamResult:
        if self.result_sink is None:
            gids = np.concatenate([b["gid"] for b in self._batches]) \
                if self._batches else np.zeros(0, np.int64)
            order = np.argsort(gids)
            if not (gids[order] == np.arange(len(gids))).all():
                raise RuntimeError(
                    "slot recycling lost or duplicated global job ids")
            cols = {k: np.concatenate([b[k] for b in self._batches])[order]
                    if self._batches else np.zeros(0, np.int64)
                    for k in _RESULT_COLS}
        else:
            cols = {k: np.zeros(0, np.int64) for k in _RESULT_COLS}
        return StreamResult(
            n_jobs=n_done, capacity=self.capacity, rounds=rounds,
            makespan=st.t, fallback_count=st.fallback_count,
            trace_overflow=self._overflow, max_live=max_live,
            final_draws=st.draws,
            events=(self._events if self.trace
                    and self.event_sink is None else None),
            n_spilled=self._spill.total, spill_peak=self._spill.peak,
            iterations=self._loop_stats.get("iterations", 0),
            acting_ticks=self._loop_stats.get("acting_ticks", 0),
            **cols)


def _reject_spilled(res: StreamResult) -> None:
    """Spilled jobs were packed later than they arrived, so the run left
    the parity domain. Checked before the monolithic comparison run."""
    if res.n_spilled:
        raise ValueError(
            f"parity window does not cover spilled runs: "
            f"{res.n_spilled} jobs waited in the host spill queue "
            f"(peak depth {res.spill_peak}) because the pool was "
            "full while they were due; raise capacity")


def _diff_vs_monolithic(cfg: SimConfig, res: StreamResult, js: JobSet,
                        time_mode: Optional[str], device) -> List[str]:
    """Run ``js`` through the monolithic ``sim_torch`` engine and return
    the names of the per-job and result fields that differ from the
    streamed ``res`` (an empty list: equal bit for bit), the draw count
    and the fallback count included."""
    jobs = sim_torch.jobs_from_jobset(js, device)
    st = sim_torch.run(cfg, jobs, cfg.seed, time_mode=time_mode)
    mono = {k: getattr(st, k).cpu().numpy()
            for k in ("finish", "preempt_count", "last_signal",
                      "last_vacate", "last_resume")}
    diff = [k for k, v in mono.items() if not (v == getattr(res, k)).all()]
    if res.makespan != st.t:
        diff.append("t")
    if res.final_draws != st.draws:
        diff.append("draws")
    if res.fallback_count != st.fallback_count:
        diff.append("fallback_count")
    return diff


def verify_prefix_parity(cfg: SimConfig, n_jobs: int = 512,
                         capacity: int = 160, chunk: int = 128,
                         time_mode: Optional[str] = None,
                         device=None) -> List[str]:
    """The parity-window contract, executable: stream a synthetic prefix
    through the macro-round engine and run the same materialized job set
    through the monolithic ``sim_torch`` engine; return the names of the
    fields that differ (an empty list: equal bit for bit). Raises when
    the streamed run spilled."""
    dev = _device.resolve(device)
    src = JobSource(workload.stream_chunks(cfg, n_jobs, chunk=chunk))
    res = StreamEngine(cfg, src, capacity=capacity, time_mode=time_mode,
                       device=dev).run()
    _reject_spilled(res)
    js = materialize(JobSource(
        workload.stream_chunks(cfg, n_jobs, chunk=chunk)))
    return _diff_vs_monolithic(cfg, res, js, time_mode, dev)


def verify_closed_loop_parity(cfg: SimConfig, n_jobs: int = 400,
                              capacity: int = 160, chunk: int = 64,
                              time_mode: Optional[str] = None,
                              device=None) -> List[str]:
    """Closed-loop twin of :func:`verify_prefix_parity`: stream a
    synthetic prefix with ``admission=True`` and run the monolithic
    pipeline (``closed_loop_submit_times`` to stamp the admit ticks, then
    ``sim_torch.run``) on the same job data; return the names of the
    fields that differ, the admit ticks (``"admit_time"``) included."""
    dev = _device.resolve(device)
    src = JobSource(workload.stream_chunks(cfg, n_jobs, chunk=chunk))
    res = StreamEngine(cfg, src, capacity=capacity, time_mode=time_mode,
                       admission=True, device=dev).run()
    _reject_spilled(res)
    data = materialize(JobSource(
        workload.stream_chunks(cfg, n_jobs, chunk=chunk)))
    data.submit = workload.closed_loop_submit_times(cfg, data)
    diff = ([] if np.array_equal(res.submit, data.submit)
            else ["admit_time"])
    return diff + _diff_vs_monolithic(cfg, res, data, time_mode, dev)

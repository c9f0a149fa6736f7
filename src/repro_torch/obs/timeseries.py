"""Derived telemetry: time-series metrics and the per-job slowdown
decomposition, both computed by replaying the canonical event stream
(the port's copy of the JAX package's ``obs/timeseries.py``).

Nothing here touches either engine — any trace that validates against
``obs.schema`` replays, so reference runs, decoded ring buffers and
CSV round-trips all feed the same analysis.

The decomposition is the paper's slowdown-rate metric made auditable:
for every finished job,

    finish - submit == initial_wait + grace_stall + requeue_wait
                       + service

where ``initial_wait`` is submit -> first placement, ``grace_stall``
sums signal -> vacate spans, ``requeue_wait`` sums vacate -> resume
spans, and ``service`` sums placement -> (signal | finish) running
spans. The identity holds exactly because a job's remaining time only
counts down while RUNNING — it is tested per job on both engines.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.obs import schema
from repro_torch.obs.schema import Event


@dataclass
class TimeSeries:
    """Step-function samples at every distinct event time ``t[i]``:
    each series holds the value AFTER all events at ``t[i]`` applied,
    valid on ``[t[i], t[i+1])``."""
    t: np.ndarray                 # (k,) i64, strictly increasing
    busy_nodes: np.ndarray        # (k,) i64
    utilization: np.ndarray       # (k,) f64, busy / n_nodes
    queue_depth_te: np.ndarray    # (k,) i64
    queue_depth_be: np.ndarray    # (k,) i64
    in_grace: np.ndarray          # (k,) i64
    cum_preemptions: np.ndarray   # (k,) i64 signals so far
    n_nodes: int

    @property
    def makespan(self) -> int:
        return int(self.t[-1]) if len(self.t) else 0

    @property
    def preempt_rate(self) -> float:
        """Preemption signals per simulated minute over the run."""
        span = self.makespan
        total = int(self.cum_preemptions[-1]) if len(self.t) else 0
        return total / span if span > 0 else 0.0

    def mean_utilization(self) -> float:
        """Time-weighted mean node utilization over the run."""
        if len(self.t) < 2:
            return 0.0
        dt = np.diff(self.t.astype(np.float64))
        return float((self.utilization[:-1] * dt).sum() / dt.sum())


def compute_timeseries(events: Sequence[Event], n_nodes: int,
                       is_te=None, preemptive: bool = True) -> TimeSeries:
    """Replay the event stream into step-function series. ``is_te``
    (per-job flags) + ``preemptive`` split the queue-depth series into
    lanes; omitted, everything counts as the BE lane."""
    placed: Dict[int, tuple] = {}
    # nodes are SHARED (demand packing): a node is busy while any job
    # holds it, so occupancy is a per-node refcount, not a set
    occ: Dict[int, int] = {}
    depth = {"TE": 0, "BE": 0}
    in_grace = 0
    signals = 0

    def release(job: int):
        for n in placed.pop(job, ()):
            occ[n] -= 1
            if not occ[n]:
                del occ[n]

    ts, bn, qt, qb, gr, cp = [], [], [], [], [], []

    def sample(t: int):
        ts.append(t)
        bn.append(len(occ))
        qt.append(depth["TE"])
        qb.append(depth["BE"])
        gr.append(in_grace)
        cp.append(signals)

    def lane(job: int) -> str:
        if preemptive and is_te is not None and bool(is_te[job]):
            return "TE"
        return "BE"

    prev_t: Optional[int] = None
    for ev in events:
        if prev_t is not None and ev.t != prev_t:
            sample(prev_t)
        prev_t = ev.t
        if ev.code == schema.SUBMIT:
            depth[lane(ev.job)] += 1
        elif ev.code in schema.PLACEMENT_CODES:
            depth[lane(ev.job)] -= 1
            placed[ev.job] = ev.nodes
            for n in ev.nodes:
                occ[n] = occ.get(n, 0) + 1
        elif ev.code == schema.PREEMPT_SIGNAL:
            signals += 1
            in_grace += 1
        elif ev.code == schema.VACATE:
            in_grace -= 1
            release(ev.job)
        elif ev.code == schema.REQUEUE:
            depth[lane(ev.job)] += 1
        elif ev.code == schema.FINISH:
            release(ev.job)
    if prev_t is not None:
        sample(prev_t)
    return TimeSeries(
        t=np.asarray(ts, np.int64),
        busy_nodes=np.asarray(bn, np.int64),
        utilization=np.asarray(bn, np.float64) / max(int(n_nodes), 1),
        queue_depth_te=np.asarray(qt, np.int64),
        queue_depth_be=np.asarray(qb, np.int64),
        in_grace=np.asarray(gr, np.int64),
        cum_preemptions=np.asarray(cp, np.int64),
        n_nodes=int(n_nodes))


@dataclass
class JobDecomposition:
    """Per-job slowdown decomposition (all in simulated minutes)."""
    job: int
    submit: int
    finish: int                   # -1 when the job never finished
    initial_wait: int
    grace_stall: int
    requeue_wait: int
    service: int

    @property
    def turnaround(self) -> int:
        return self.finish - self.submit

    def identity_holds(self) -> bool:
        return (self.finish >= 0 and
                self.turnaround == self.initial_wait + self.grace_stall
                + self.requeue_wait + self.service)


def slowdown_decomposition(events: Sequence[Event]
                           ) -> Dict[int, JobDecomposition]:
    """Split every job's turnaround into its four phases by replaying
    its lifecycle (see module docstring for the identity)."""
    out: Dict[int, JobDecomposition] = {}
    # per-job running state
    sub: Dict[int, int] = {}
    first_start: Dict[int, int] = {}
    place_t: Dict[int, int] = {}
    signal_t: Dict[int, int] = {}
    vacate_t: Dict[int, int] = {}
    stall: Dict[int, int] = {}
    rq_wait: Dict[int, int] = {}
    service: Dict[int, int] = {}
    for ev in events:
        j = ev.job
        if ev.code == schema.SUBMIT:
            sub[j] = ev.t
        elif ev.code in schema.PLACEMENT_CODES:
            if j not in first_start:
                first_start[j] = ev.t
            if ev.code == schema.RESUME and j in vacate_t:
                rq_wait[j] = rq_wait.get(j, 0) + ev.t - vacate_t.pop(j)
            place_t[j] = ev.t
        elif ev.code == schema.PREEMPT_SIGNAL:
            signal_t[j] = ev.t
            if j in place_t:
                service[j] = service.get(j, 0) + ev.t - place_t.pop(j)
        elif ev.code == schema.VACATE:
            vacate_t[j] = ev.t
            if j in signal_t:
                stall[j] = stall.get(j, 0) + ev.t - signal_t.pop(j)
        elif ev.code == schema.FINISH:
            if j in place_t:
                service[j] = service.get(j, 0) + ev.t - place_t.pop(j)
            out[j] = JobDecomposition(
                job=j, submit=sub.get(j, 0), finish=ev.t,
                initial_wait=first_start.get(j, ev.t) - sub.get(j, 0),
                grace_stall=stall.get(j, 0),
                requeue_wait=rq_wait.get(j, 0),
                service=service.get(j, 0))
    # unfinished jobs: report what is known, finish = -1
    for j, s in sub.items():
        if j not in out:
            out[j] = JobDecomposition(
                job=j, submit=s, finish=-1,
                initial_wait=(first_start[j] - s) if j in first_start
                else -1,
                grace_stall=stall.get(j, 0),
                requeue_wait=rq_wait.get(j, 0),
                service=service.get(j, 0))
    return out


def format_timeseries(series: TimeSeries, max_rows: int = 20) -> str:
    """Aligned text table of the series, downsampled to ``max_rows``
    evenly spaced samples (CLI / example output)."""
    k = len(series.t)
    idx = (range(k) if k <= max_rows
           else np.linspace(0, k - 1, max_rows).astype(int))
    hdr = (f"{'t':>8s} {'util':>6s} {'busy':>5s} {'q_te':>5s} "
           f"{'q_be':>5s} {'grace':>5s} {'preempts':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for i in idx:
        lines.append(
            f"{series.t[i]:8d} {series.utilization[i]:6.2f} "
            f"{series.busy_nodes[i]:5d} {series.queue_depth_te[i]:5d} "
            f"{series.queue_depth_be[i]:5d} {series.in_grace[i]:5d} "
            f"{series.cum_preemptions[i]:8d}")
    return "\n".join(lines)

"""Trace exporters: Chrome-trace/Perfetto JSON and CSV.

Both formats serialize the canonical ``obs.schema.Event`` stream.
The Perfetto export opens directly in https://ui.perfetto.dev (or
``chrome://tracing``): one track per cluster node showing job
occupancy slices, one counter track per queue lane plus utilization /
jobs-in-grace, and instant markers for preemption signals. CSV is the
lossless round-trippable form (``read_csv(write) == events``).

Timestamps: Chrome trace ``ts`` is microseconds; we map one simulated
minute to 1 µs (``TS_PER_MIN``), so the UI's "1 ms" ruler reads as
1000 simulated minutes.
"""
from __future__ import annotations

import csv
import io
import json
from typing import Dict, List, Optional, Sequence

from repro_torch.obs import schema
from repro_torch.obs.schema import Event

TS_PER_MIN = 1          # Chrome-trace µs per simulated minute
_PID_NODES = 1
_PID_METRICS = 2

CSV_FIELDS = ("t", "event", "job", "aux", "nodes")


def to_csv(events: Sequence[Event]) -> str:
    """Lossless CSV serialization (header + one row per event;
    ``nodes`` is a '+'-joined node list, empty when none)."""
    out = io.StringIO()
    w = csv.writer(out)
    w.writerow(CSV_FIELDS)
    for ev in events:
        w.writerow([ev.t, ev.name, ev.job, ev.aux,
                    "+".join(str(n) for n in ev.nodes)])
    return out.getvalue()


def read_csv(text: str) -> List[Event]:
    """Inverse of :func:`to_csv`."""
    rd = csv.reader(io.StringIO(text))
    header = next(rd)
    if tuple(header) != CSV_FIELDS:
        raise ValueError(f"not a trace CSV (header {header!r})")
    code_of = {name: i for i, name in enumerate(schema.EVENT_NAMES)}
    events = []
    for row in rd:
        if not row:
            continue
        t, name, job, aux, nodes = row
        events.append(Event(
            t=int(t), code=code_of[name], job=int(job), aux=int(aux),
            nodes=tuple(int(n) for n in nodes.split("+")) if nodes else ()))
    return events


def _lane_of(job: int, is_te, preemptive: bool) -> str:
    if preemptive and is_te is not None and bool(is_te[job]):
        return "TE"
    return "BE"


def to_perfetto(events: Sequence[Event], n_nodes: Optional[int] = None,
                is_te=None, preemptive: bool = True) -> Dict:
    """Chrome-trace (Perfetto-compatible) JSON object.

    Track layout: pid 1 "cluster" with one thread per node (occupancy
    slices named after the running job, preemption-signal instants);
    pid 2 "metrics" with counter tracks — queue depth per lane,
    jobs-in-grace, busy nodes (utilization numerator). ``is_te`` (any
    indexable of per-job flags) + ``preemptive`` derive the queue lane
    of each job; omitted, every job counts in the BE lane.
    """
    tr: List[Dict] = [
        {"ph": "M", "pid": _PID_NODES, "name": "process_name",
         "args": {"name": "cluster"}},
        {"ph": "M", "pid": _PID_METRICS, "name": "process_name",
         "args": {"name": "metrics"}},
    ]
    max_node = max((max(ev.nodes) for ev in events if ev.nodes), default=-1)
    n_tracks = max(n_nodes or 0, max_node + 1)
    for node in range(n_tracks):
        tr.append({"ph": "M", "pid": _PID_NODES, "tid": node,
                   "name": "thread_name",
                   "args": {"name": f"node {node}"}})

    placed: Dict[int, tuple] = {}        # job -> (t_placed, node tuple)
    depth = {"TE": 0, "BE": 0}
    in_grace = 0
    # nodes are SHARED (demand packing): busy = nodes held by >= 1 job
    occ: Dict[int, int] = {}
    counters_dirty = True

    def counters(t: int):
        tr.append({"ph": "C", "pid": _PID_METRICS, "name": "queue depth",
                   "ts": t * TS_PER_MIN,
                   "args": {"TE lane": depth["TE"], "BE lane": depth["BE"]}})
        tr.append({"ph": "C", "pid": _PID_METRICS, "name": "in grace",
                   "ts": t * TS_PER_MIN, "args": {"jobs": in_grace}})
        tr.append({"ph": "C", "pid": _PID_METRICS, "name": "busy nodes",
                   "ts": t * TS_PER_MIN, "args": {"nodes": len(occ)}})

    def begin(ev: Event):
        placed[ev.job] = (ev.t, ev.nodes)
        for node in ev.nodes:
            occ[node] = occ.get(node, 0) + 1

    def end(ev: Event, released_by: str):
        # occupancy slices are "X" complete events, emitted at release
        # time with their full duration — concurrent jobs on a shared
        # node overlap freely, which stack-matched B/E pairs cannot
        # represent on one track
        t0, nodes = placed.pop(ev.job, (ev.t, ()))
        for node in nodes:
            tr.append({"ph": "X", "pid": _PID_NODES, "tid": node,
                       "ts": t0 * TS_PER_MIN,
                       "dur": max(ev.t - t0, 0) * TS_PER_MIN,
                       "name": f"job {ev.job}",
                       "args": {"job": ev.job, "released_by": released_by}})
            occ[node] -= 1
            if not occ[node]:
                del occ[node]

    prev_t = None
    for ev in events:
        if counters_dirty and prev_t is not None and ev.t != prev_t:
            counters(prev_t)
            counters_dirty = False
        if ev.t != prev_t:
            prev_t = ev.t
        lane = _lane_of(ev.job, is_te, preemptive)
        if ev.code == schema.SUBMIT:
            depth[lane] += 1
            counters_dirty = True
        elif ev.code in schema.PLACEMENT_CODES:
            depth[lane] -= 1
            begin(ev)
            counters_dirty = True
        elif ev.code == schema.PREEMPT_SIGNAL:
            node = placed.get(ev.job, (ev.t, (0,)))[1]
            tid = node[0] if node else 0
            tr.append({"ph": "i", "pid": _PID_NODES, "tid": tid,
                       "ts": ev.t * TS_PER_MIN, "s": "t",
                       "name": f"signal job {ev.job} (te {ev.aux})"})
            in_grace += 1
            counters_dirty = True
        elif ev.code == schema.VACATE:
            end(ev, "vacate")
            in_grace -= 1
            counters_dirty = True
        elif ev.code == schema.REQUEUE:
            depth[lane] += 1
            counters_dirty = True
        elif ev.code == schema.FINISH:
            end(ev, "finish")
            counters_dirty = True
    if counters_dirty and prev_t is not None:
        counters(prev_t)
    # jobs still placed when the trace ends: close their slices at the
    # last event time so the track is complete
    if prev_t is not None:
        for job in sorted(placed):
            end(Event(t=prev_t, code=schema.FINISH, job=job), "trace-end")
    return {"traceEvents": tr, "displayTimeUnit": "ms",
            "otherData": {"ts_per_minute": TS_PER_MIN}}


class CsvTraceWriter:
    """Incremental trace-CSV writer for streamed runs.

    Same dialect as :func:`to_csv` / :func:`read_csv`, but appends
    batches as they come instead of holding the whole stream, so a
    trace lands on disk batch by batch in O(batch) memory:

        with CsvTraceWriter(path) as w:
            for batch in batches:
                w.write(batch)
        read_csv(open(path).read())     # == the full event stream
    """

    def __init__(self, path: str):
        self._f = open(path, "w", newline="")
        self._w = csv.writer(self._f)
        self._w.writerow(CSV_FIELDS)
        self.n_written = 0

    def write(self, events: Sequence[Event]) -> None:
        for ev in events:
            self._w.writerow([ev.t, ev.name, ev.job, ev.aux,
                              "+".join(str(n) for n in ev.nodes)])
        self.n_written += len(events)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "CsvTraceWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_trace(path: str, events: Sequence[Event], fmt: str = "perfetto",
                n_nodes: Optional[int] = None, is_te=None,
                preemptive: bool = True) -> None:
    """Write the event stream to ``path`` as ``fmt``
    (``"perfetto"`` JSON or ``"csv"``)."""
    if fmt == "perfetto":
        with open(path, "w") as f:
            json.dump(to_perfetto(events, n_nodes=n_nodes, is_te=is_te,
                                  preemptive=preemptive), f)
    elif fmt == "csv":
        with open(path, "w") as f:
            f.write(to_csv(events))
    else:
        raise ValueError(f"unknown trace format {fmt!r}; "
                         "one of ('perfetto', 'csv')")

"""JobSource: a buffered pull interface over a stream of job chunks.

A *job source* is any iterator of submit-sorted :class:`JobSet` chunks
whose submit times are non-decreasing across chunks too: the chunked
synthetic generator (``core/workload.stream_chunks``), the trace
readers (``scenarios/traces.iter_trace_csv``, ``tiled_trace_chunks``)
and :func:`from_jobset` all qualify. :class:`JobSource` wraps one with
``take(k)`` (pull up to k jobs), ``take_due(t)`` and ``peek_submit()``,
holding at most one chunk in memory, and checks the ordering contract
where it would otherwise corrupt queue keys.

``scan`` and ``materialize`` consume a source whole: ``scan`` in one
bounded-memory pass, ``materialize`` into one monolithic ``JobSet``
(what the scenario registry hands the engine). Host numpy only.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional

import numpy as np

from repro_torch.core.types import JobSet

_FIELDS = ("submit", "exec_total", "demand", "is_te", "gp", "n_nodes")


class JobSource:
    """Buffered pull interface over an iterator of JobSet chunks.

    ``stats`` is an optional passthrough for reader-side accounting
    (e.g. ``scenarios.traces.TraceStats`` drop counters)."""

    def __init__(self, chunks: Iterable[JobSet], stats=None):
        self._it: Optional[Iterator[JobSet]] = iter(chunks)
        self._head: Optional[JobSet] = None
        self._off = 0
        self._last_submit: Optional[int] = None
        self.stats = stats
        self.n_taken = 0

    def _refill(self) -> bool:
        """Ensure the head chunk has an unread row; False = exhausted."""
        while self._head is None or self._off >= self._head.n:
            if self._it is None:
                return False
            try:
                js = next(self._it)
            except StopIteration:
                self._it, self._head = None, None
                return False
            if js.n == 0:
                continue
            if not (np.diff(js.submit) >= 0).all():
                raise ValueError("JobSource chunk is not submit-sorted")
            if (self._last_submit is not None
                    and int(js.submit[0]) < self._last_submit):
                raise ValueError(
                    "JobSource submit times decrease across chunks "
                    f"({self._last_submit} -> {int(js.submit[0])}); the "
                    "stream contract requires globally non-decreasing "
                    "submits")
            self._last_submit = int(js.submit[-1])
            self._head, self._off = js, 0
        return True

    @property
    def exhausted(self) -> bool:
        return not self._refill()

    def peek_submit(self) -> Optional[int]:
        """Submit tick of the next un-taken job; None when exhausted."""
        if not self._refill():
            return None
        return int(self._head.submit[self._off])

    def _concat(self, parts: List[tuple], got: int) -> JobSet:
        self.n_taken += got
        return JobSet(**{
            f: np.concatenate([getattr(js, f)[a:b] for js, a, b in parts])
            for f in _FIELDS})

    def take(self, k: int) -> Optional[JobSet]:
        """Pull up to ``k`` jobs (in stream order) as one JobSet; None
        when the source is exhausted."""
        parts: List[tuple] = []
        got = 0
        while got < k and self._refill():
            js, off = self._head, self._off
            n = min(k - got, js.n - off)
            parts.append((js, off, off + n))
            self._off = off + n
            got += n
        return self._concat(parts, got) if got else None

    def take_due(self, t: int) -> Optional[JobSet]:
        """Pull every job whose submit time is ``<= t`` (in stream
        order) as one JobSet; None when no job is due."""
        parts: List[tuple] = []
        got = 0
        while self._refill():
            js, off = self._head, self._off
            # chunks are submit-sorted, so the due prefix is a slice
            n = int(np.searchsorted(js.submit[off:], t, side="right"))
            if n == 0:
                break
            parts.append((js, off, off + n))
            self._off = off + n
            got += n
            if self._off < js.n:
                break                     # first not-yet-due job reached
        return self._concat(parts, got) if got else None


@dataclass
class ScanStats:
    """One-pass stream summary."""
    n_jobs: int = 0
    n_te: int = 0
    n_gang: int = 0
    first_submit: int = -1
    last_submit: int = -1
    total_exec_min: int = 0
    stats: object = field(default=None, repr=False)   # reader accounting

    @property
    def n_be(self) -> int:
        return self.n_jobs - self.n_te

    @property
    def horizon(self) -> int:
        return max(self.last_submit - max(self.first_submit, 0), 0)


def scan(source: JobSource, chunk: int = 8192) -> ScanStats:
    """Consume ``source`` in one bounded-memory pass and summarize."""
    out = ScanStats()
    while True:
        js = source.take(chunk)
        if js is None:
            break
        if out.n_jobs == 0:
            out.first_submit = int(js.submit[0])
        out.last_submit = int(js.submit[-1])
        out.n_jobs += js.n
        out.n_te += int(js.is_te.sum())
        out.n_gang += int((np.asarray(js.n_nodes) > 1).sum())
        out.total_exec_min += int(js.exec_total.sum())
    out.stats = source.stats
    return out


def materialize(source: JobSource, chunk: int = 65536) -> JobSet:
    """Concatenate a whole source into one monolithic JobSet."""
    parts: List[JobSet] = []
    while True:
        js = source.take(chunk)
        if js is None:
            break
        parts.append(js)
    if not parts:
        raise ValueError("materialize() of an empty job source")
    return JobSet(**{
        f: np.concatenate([getattr(js, f) for js in parts])
        for f in _FIELDS})


def from_jobset(js: JobSet, chunk: int = 4096) -> JobSource:
    """A JobSource over an already-materialized JobSet (chunked views,
    no copies)."""
    def gen():
        for a in range(0, js.n, int(chunk)):
            b = min(a + int(chunk), js.n)
            yield JobSet(**{f: getattr(js, f)[a:b] for f in _FIELDS})

    return JobSource(gen())

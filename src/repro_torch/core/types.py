"""Core scheduler types: the job set, the job-state constants and the
reference engine's result types (``PreemptionEvent``, ``SimResult``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

# Job states
NOT_ARRIVED = 0
QUEUED = 1
RUNNING = 2
GRACE = 3      # preemption signalled; performing suspension processing
DONE = 4


@dataclass
class JobSet:
    """Static workload description (struct-of-arrays over n jobs).

    demand[:, r] for r in (CPU, RAM, GPU); times in integer minutes.
    ``n_nodes`` is the gang width; ``demand`` is PER NODE.
    """
    submit: np.ndarray          # (n,) int
    exec_total: np.ndarray      # (n,) int >= 1
    demand: np.ndarray          # (n, 3) float
    is_te: np.ndarray           # (n,) bool
    gp: np.ndarray              # (n,) int grace period, minutes
    n_nodes: np.ndarray = None  # (n,) int >= 1; None -> all single-node

    def __post_init__(self):
        if self.n_nodes is None:
            self.n_nodes = np.ones(len(self.submit), np.int64)

    @property
    def n(self) -> int:
        return len(self.submit)

    def validate(self, node_cap: np.ndarray) -> None:
        """Raise ValueError on a job set no engine could run."""
        checks = (
            ((self.exec_total >= 1).all(), "exec_total must be >= 1"),
            ((self.demand >= 0).all(), "demand must be >= 0"),
            ((self.demand <= node_cap[None, :]).all(),
             "job demand must fit on a single node"),
            ((self.gp >= 0).all(), "grace periods must be >= 0"),
            ((np.diff(self.submit) >= 0).all(),
             "jobs must be sorted by submit time"),
        )
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)


# Human-readable state names (engine assertion messages).
STATE_NAMES = {NOT_ARRIVED: "not_arrived", QUEUED: "queued",
               RUNNING: "running", GRACE: "grace", DONE: "done"}


@dataclass
class PreemptionEvent:
    job: int
    te_job: int                 # the TE arrival that triggered it
    signal_time: int            # grace period start
    vacate_time: int = -1
    resume_time: int = -1

    def as_tuple(self):
        """Canonical comparison key (engine-parity tests)."""
        return (self.job, self.te_job, self.signal_time,
                self.vacate_time, self.resume_time)


@dataclass
class SimResult:
    """A reference run's result: everything the paper's tables need.

    ``trace`` is the canonical scheduler-event stream
    (``obs.schema.Event`` rows) when the run was traced
    (``simulate(trace=True)``), else None.
    """
    finish: np.ndarray            # (n,) completion tick
    exec_total: np.ndarray
    submit: np.ndarray
    is_te: np.ndarray
    preempt_count: np.ndarray     # (n,)
    events: List[PreemptionEvent] = field(default_factory=list)
    makespan: int = 0
    trace: Optional[List] = None  # List[obs.schema.Event]

    @property
    def slowdown(self) -> np.ndarray:
        """Eq. 5: 1 + Waiting/Execution, Waiting = turnaround - execution."""
        waiting = self.finish - self.submit - self.exec_total
        return 1.0 + waiting / self.exec_total

    @property
    def resched_intervals(self) -> np.ndarray:
        """Minutes between the preemption signal and resuming (Table 2),
        grace period included."""
        iv = [e.resume_time - e.signal_time for e in self.events
              if e.resume_time >= 0]
        return np.asarray(iv, dtype=np.float64)

    def preempted_fraction(self) -> float:
        """Proportion of BE jobs preempted at least once (Table 3);
        ``nan`` for an all-TE jobset."""
        be = ~self.is_te
        if not be.any():
            return float("nan")
        return float((self.preempt_count[be] > 0).mean())

    def preempt_count_fractions(self) -> Dict[str, float]:
        """Proportion preempted exactly 1 / 2 / >=3 times (Table 4)."""
        be = ~self.is_te
        c = self.preempt_count[be]
        n = max(len(c), 1)
        return {"1": float((c == 1).sum()) / n,
                "2": float((c == 2).sum()) / n,
                ">=3": float((c >= 3).sum()) / n}

"""Core scheduler types: the job set and the job-state constants."""
from __future__ import annotations

from dataclasses import dataclass

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

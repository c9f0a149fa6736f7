"""Node-level placement: first-fit and gang (all-or-nothing) fitting,
float64 host state.

``FIT_EPS`` is the epsilon of every resource-fit comparison in the
port, as in the JAX package: demands are floats and alloc/release
round trips accumulate dust, so every "does it fit" test is
slack-tolerant.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

FIT_EPS = 1e-9


class ClusterState:
    """Per-node free / pending-free resource vectors plus fit queries,
    used by the reference engine (``engine/core.py``) and the
    closed-loop admission run (``core/simulator.py``).

    ``free`` is what is allocatable right now; ``pending_free`` is
    demand already promised back by in-flight grace periods (signalled
    victims that have not vacated yet): incoming supply, not current
    supply. A TE preempts only when even ``free + pending_free`` cannot
    fit it (the paper's "the resource is insufficient").
    """

    def __init__(self, n_nodes: int, node_cap) -> None:
        self.node_cap = np.asarray(node_cap, np.float64)
        self.n_nodes = int(n_nodes)
        self.free = np.tile(self.node_cap, (self.n_nodes, 1))
        self.pending_free = np.zeros((self.n_nodes, self.node_cap.size))

    # -- queries -------------------------------------------------------------

    def fitting_nodes(self, demand: np.ndarray) -> np.ndarray:
        """Indices of nodes whose free vector fits ``demand``."""
        fits = np.all(self.free >= demand[None, :] - FIT_EPS, axis=1)
        return np.flatnonzero(fits)

    def first_fit(self, demand: np.ndarray) -> int:
        """First node fitting ``demand``, or -1."""
        idx = self.fitting_nodes(demand)
        return int(idx[0]) if len(idx) else -1

    def fits_job(self, demand: np.ndarray, width: int = 1
                 ) -> Optional[np.ndarray]:
        """First ``width`` nodes that each fit the per-node ``demand``,
        or None. ``width`` == 1 is first-fit."""
        idx = self.fitting_nodes(demand)
        return idx[:width] if len(idx) >= width else None

    def fits_with_pending(self, demand: np.ndarray, width: int = 1) -> bool:
        """Would the job fit counting resources already promised by
        in-flight grace periods? (The preemption trigger's test.)"""
        promised = self.free + self.pending_free
        fits = np.all(promised >= demand[None, :] - FIT_EPS, axis=1)
        return int(fits.sum()) >= width

    # -- mutations -----------------------------------------------------------

    def alloc(self, nodes: np.ndarray, demand: np.ndarray) -> None:
        self.free[nodes] -= demand

    def release(self, nodes: np.ndarray, demand: np.ndarray) -> None:
        self.free[nodes] += demand

    def promise(self, nodes: np.ndarray, demand: np.ndarray) -> None:
        """Record a signalled victim's demand as incoming supply."""
        self.pending_free[nodes] += demand

    def unpromise(self, nodes: np.ndarray, demand: np.ndarray) -> None:
        """The victim vacated: its supply is real now (in ``free``)."""
        self.pending_free[nodes] -= demand

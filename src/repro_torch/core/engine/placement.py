"""Node-level first-fit placement (float64 host state).

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
    """Per-node free resource vectors plus the first-fit query used by
    the closed-loop admission run (``core/simulator.py``)."""

    def __init__(self, n_nodes: int, node_cap) -> None:
        self.node_cap = np.asarray(node_cap, np.float64)
        self.n_nodes = int(n_nodes)
        self.free = np.tile(self.node_cap, (self.n_nodes, 1))

    def fitting_nodes(self, demand: np.ndarray) -> np.ndarray:
        """Indices of nodes whose free vector fits ``demand``."""
        fits = np.all(self.free >= demand[None, :] - FIT_EPS, axis=1)
        return np.flatnonzero(fits)

    def fits_job(self, demand: np.ndarray, width: int = 1
                 ) -> Optional[np.ndarray]:
        """First ``width`` nodes that each fit the per-node ``demand``,
        or None. ``width`` == 1 is first-fit."""
        idx = self.fitting_nodes(demand)
        return idx[:width] if len(idx) >= width else None

    def alloc(self, nodes: np.ndarray, demand: np.ndarray) -> None:
        self.free[nodes] -= demand

    def release(self, nodes: np.ndarray, demand: np.ndarray) -> None:
        self.free[nodes] += demand

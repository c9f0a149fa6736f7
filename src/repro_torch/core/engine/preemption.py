"""Victim-selection marshalling of the reference engine (the port's
copy of the JAX package's ``core/engine/preemption.py``).

The *decision rule* lives in ``core/policies.py`` (Eq. 1-4 and the
baselines); this module owns the glue the paper leaves implicit:
which node a multi-node victim is evaluated against (Eq. 2), the
under-P-cap-first ordering, and the gang (multi-node TE) selection
strategy. Pure functions over arrays — no scheduler state is mutated
here; the :class:`~repro_torch.core.engine.core.SchedulerCore` signals the
returned victims.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.core.engine.placement import FIT_EPS


def best_victim_node(nodes: np.ndarray, free: np.ndarray,
                     victim_demand: np.ndarray,
                     te_demand: np.ndarray) -> int:
    """Node of a victim with the most slack for ``te_demand`` (Eq. 2 is
    evaluated against the victim's best node; single-node jobs keep
    their only node, preserving the paper's exact semantics)."""
    if len(nodes) == 1:
        return int(nodes[0])
    slack = np.min(free[nodes] + victim_demand[None, :]
                   - te_demand[None, :], axis=1)
    return int(nodes[int(np.argmax(slack))])


def ranked_order(policy, rng, cand_demand, cand_gp, cand_remaining,
                 under_cap, node_cap) -> np.ndarray:
    """Candidate positions in the policy's preemption order:
    under-P-cap candidates first, then by the policy's rank key."""
    key = policy.rank_key(rng=rng, cand_demand=cand_demand,
                          cand_gp=cand_gp, cand_remaining=cand_remaining,
                          node_cap=node_cap)
    return np.lexsort((key, ~under_cap))


def gang_select(*, policy, rng, te_demand: np.ndarray, width: int,
                free: np.ndarray, cand_ids: np.ndarray,
                cand_nodes: Sequence[np.ndarray], cand_demand: np.ndarray,
                cand_width: np.ndarray, cand_gp: np.ndarray,
                cand_remaining: np.ndarray,
                under_cap: np.ndarray, node_cap: np.ndarray) -> List[int]:
    """Multi-node TE (paper future work): Eq. 2/4 generalized — prefer
    the min-score SINGLE victim whose eviction alone yields >= width
    satisfying nodes (the paper's minimize-preemption-count strategy);
    otherwise accumulate victims in policy order until the gang fits.
    Returns victim job ids to signal ([] when nothing would suffice —
    signalling then would burn preemption budget for no gain)."""
    if len(cand_ids) == 0:
        return []

    def n_fit(fr: np.ndarray) -> int:
        return int(np.all(fr >= te_demand[None, :] - FIT_EPS, axis=1).sum())

    order = ranked_order(policy, rng,
                         cand_demand * cand_width[:, None],
                         cand_gp, cand_remaining, under_cap, node_cap)
    if policy.argmin_select:                 # Eq. 4-style score policies
        pool = [i for i in order if under_cap[i]] or list(order)
        for i in pool:                       # Eq. 4: min score first
            trial = free.copy()
            trial[cand_nodes[i]] += cand_demand[i]
            if n_fit(trial) >= width:
                return [int(cand_ids[i])]
    pending = free.copy()
    victims: List[int] = []
    for i in order:
        if n_fit(pending) >= width:
            break
        pending[cand_nodes[i]] += cand_demand[i]
        victims.append(int(cand_ids[i]))
    return victims if n_fit(pending) >= width else []

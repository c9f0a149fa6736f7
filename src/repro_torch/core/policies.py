"""Preemption decision rules: FitGpp (the paper, Eq. 1-4) + baselines.

A policy answers one question: given a TE job that does not fit
anywhere, which running BE job(s) should be signalled to vacate? Each
rule is registered once in the port's policy table
(``core/policy_registry.py``) with both of its halves:

* the torch engine's declaration (``score`` / ``rank`` below), the
  mirror of the JAX package's ``jax_score`` / ``jax_rank``;
* the numpy reference engine's decision rule (a :class:`Policy`
  subclass with ``select`` / ``rank_key``), the port's copy of the JAX
  package's numpy halves, instantiated by ``policy_registry.make``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.configs.base import PAPER_S
from repro_torch.core.engine.placement import FIT_EPS
from repro_torch.core.policy_registry import PolicySpec, register_policy
from repro_torch.kernels.schedule_step import size_eq1 as size_eq1_torch


def fitgpp_score(jobs, cand, node_cap, s):
    """Eq. 3: size/maxSize + s*GP/maxGP, normalizers over the running
    BE candidates (the paper's J), clamped at 1e-12.

    The engine reads fitgpp's victim from the fused schedule pass
    (``victim_from_pass``), which computes this same score; this plain
    form is the rule's declaration, held against the JAX package's
    ``jax_score`` by the tests."""
    sz = size_eq1_torch(jobs.demand, node_cap)
    max_sz = torch.where(cand, sz, 0.0).max().clamp(min=1e-12)
    max_gp = torch.where(cand, jobs.gp, 0).max().float().clamp(min=1e-12)
    return sz / max_sz + s * (jobs.gp / max_gp)


def minsize_score(jobs, cand, node_cap, s):
    """Eq. 1 only: the FitGpp ablation without the grace-period term."""
    return size_eq1_torch(jobs.demand, node_cap)


def lrtp_rank(st, jobs, uniform):
    """Big-C's LRTP: longest remaining time preempted first."""
    return st.remaining.float()


def srtp_rank(st, jobs, uniform):
    """Shortest remaining time preempted first."""
    return -st.remaining.float()


def rand_rank(st, jobs, uniform):
    """Random victims: one uniform draw per job per selection."""
    return uniform()


# ---------------------------------------------------------------------------
# the numpy reference engine's decision rules
# ---------------------------------------------------------------------------

def size_eq1(demand: np.ndarray, node_cap: np.ndarray) -> np.ndarray:
    """Eq. 1: scale-invariant demand size, ||D / capacity||_2 (numpy;
    demand (..., 3), node_cap (3,))."""
    return np.sqrt(np.sum((demand / node_cap) ** 2, axis=-1))


def fitgpp_scores(demand: np.ndarray, gp: np.ndarray, node_cap: np.ndarray,
                  s: float) -> np.ndarray:
    """Eq. 3 over the set of running BE jobs; the normalizers are the
    max over ALL running BE jobs (the paper's J), not just the eligible
    subset."""
    sz = size_eq1(demand, node_cap)
    max_sz = max(sz.max(initial=0.0), 1e-12)
    max_gp = max(gp.max(initial=0), 1e-12)
    return sz / max_sz + s * (gp / max_gp)


def eligible_eq2(te_demand: np.ndarray, demand: np.ndarray,
                 node_free: np.ndarray) -> np.ndarray:
    """Eq. 2: D_TE <= D_j + N_free(node_j), element-wise, per job,
    ``FIT_EPS``-tolerant like every other fit check."""
    return np.all(te_demand[None, :] <= demand + node_free + FIT_EPS, axis=1)


class Policy:
    """Base decision rule of the reference engine.

    ``select`` returns victim job indices (into the global job array);
    ``rank_key`` returns a per-candidate preemption-order key, LOWER =
    preempt first (the gang selection's order; ``cand_demand`` arrives
    pre-scaled by gang width so Eq. 1 sees total demand).
    ``argmin_select`` marks the Eq. 4-style single-victim rules.
    ``fallback_count`` counts the score rules' random fallbacks (no
    eligible candidate under the P cap), the reference engine's side of
    the torch engine's ``State.fallback_count`` for width-1 TEs.
    """
    name = "base"
    preemptive = True
    argmin_select = False

    def __init__(self, s: float = PAPER_S):
        self.s = float(s)
        self.fallback_count = 0

    def select(self, rng, te_demand, cand_ids, cand_demand, cand_node_free,
               cand_gp, cand_remaining, under_cap, all_run_demand,
               all_run_gp, node_cap, free_by_node, cand_node) -> List[int]:
        """Victim job indices. ``cand_*`` arrays cover ALL running BE
        jobs; ``under_cap`` marks those with PreemptionCount < P;
        ``all_run_*`` equal ``cand_*`` (Eq. 3 normalizes over all
        running BE jobs)."""
        raise NotImplementedError

    def rank_key(self, rng, cand_demand, cand_gp, cand_remaining,
                 node_cap) -> np.ndarray:
        raise NotImplementedError


class FifoPolicy(Policy):
    """Non-preemptive FIFO baseline (TE and BE share one queue)."""
    name = "fifo"
    preemptive = False

    def select(self, *a, **k) -> List[int]:
        return []


def _argmin_score_select(policy, rng, cand_ids, scores, elig,
                         under_cap) -> List[int]:
    """Eq. 4 shape shared by the score policies: argmin score among
    eligible under-P-cap candidates; fallback (paper): preempt a random
    running BE job, counted in ``policy.fallback_count``."""
    mask = elig & under_cap
    if mask.any():
        masked = np.where(mask, scores, np.inf)
        return [int(cand_ids[int(np.argmin(masked))])]
    policy.fallback_count += 1
    pick = int(rng.integers(len(cand_ids)))
    return [int(cand_ids[pick])]


def _preempt_until_fits(order, te_demand, cand_ids, cand_demand, cand_node,
                        under_cap, free_by_node) -> List[int]:
    """Walk candidates in ``order`` (under the P cap first), accumulating
    pending frees per node, until the TE job fits on some node."""
    pending = free_by_node.copy()
    victims: List[int] = []
    ordered = [i for i in order if under_cap[i]] + \
              [i for i in order if not under_cap[i]]
    for i in ordered:
        node = int(cand_node[i])
        pending[node] += cand_demand[i]
        victims.append(int(cand_ids[i]))
        if np.all(te_demand <= pending[node] + FIT_EPS):
            return victims
    return victims   # even preempting everyone was not enough


class FitGppPolicy(Policy):
    """The paper's algorithm (Eq. 1-4)."""
    name = "fitgpp"
    argmin_select = True

    def select(self, rng, te_demand, cand_ids, cand_demand, cand_node_free,
               cand_gp, cand_remaining, under_cap, all_run_demand,
               all_run_gp, node_cap, free_by_node, cand_node) -> List[int]:
        if len(cand_ids) == 0:
            return []
        scores = fitgpp_scores(all_run_demand, all_run_gp, node_cap, self.s)
        elig = eligible_eq2(te_demand, cand_demand, cand_node_free)
        return _argmin_score_select(self, rng, cand_ids, scores, elig,
                                    under_cap)

    def rank_key(self, rng, cand_demand, cand_gp, cand_remaining,
                 node_cap) -> np.ndarray:
        return fitgpp_scores(cand_demand, cand_gp, node_cap, self.s)


class MinSizePolicy(Policy):
    """FitGpp without the grace-period term: argmin of the Eq. 1 size
    among Eq. 2-eligible candidates."""
    name = "minsize"
    argmin_select = True

    def select(self, rng, te_demand, cand_ids, cand_demand, cand_node_free,
               cand_gp, cand_remaining, under_cap, all_run_demand,
               all_run_gp, node_cap, free_by_node, cand_node) -> List[int]:
        if len(cand_ids) == 0:
            return []
        scores = size_eq1(all_run_demand, node_cap)
        elig = eligible_eq2(te_demand, cand_demand, cand_node_free)
        return _argmin_score_select(self, rng, cand_ids, scores, elig,
                                    under_cap)

    def rank_key(self, rng, cand_demand, cand_gp, cand_remaining,
                 node_cap) -> np.ndarray:
        return size_eq1(cand_demand, node_cap)


class LrtpPolicy(Policy):
    """Big-C's LRTP: keep preempting, longest remaining first, until
    some node could fit the TE job."""
    name = "lrtp"

    def select(self, rng, te_demand, cand_ids, cand_demand, cand_node_free,
               cand_gp, cand_remaining, under_cap, all_run_demand,
               all_run_gp, node_cap, free_by_node, cand_node) -> List[int]:
        return _preempt_until_fits(
            np.argsort(-cand_remaining, kind="stable"), te_demand,
            cand_ids, cand_demand, cand_node, under_cap, free_by_node)

    def rank_key(self, rng, cand_demand, cand_gp, cand_remaining,
                 node_cap) -> np.ndarray:
        return -np.asarray(cand_remaining, float)


class SrtpPolicy(Policy):
    """Shortest remaining time preempted first (the LRTP mirror)."""
    name = "srtp"

    def select(self, rng, te_demand, cand_ids, cand_demand, cand_node_free,
               cand_gp, cand_remaining, under_cap, all_run_demand,
               all_run_gp, node_cap, free_by_node, cand_node) -> List[int]:
        return _preempt_until_fits(
            np.argsort(cand_remaining, kind="stable"), te_demand,
            cand_ids, cand_demand, cand_node, under_cap, free_by_node)

    def rank_key(self, rng, cand_demand, cand_gp, cand_remaining,
                 node_cap) -> np.ndarray:
        return np.asarray(cand_remaining, float)


class RandPolicy(Policy):
    """Random running BE victims until the TE fits."""
    name = "rand"

    def select(self, rng, te_demand, cand_ids, cand_demand, cand_node_free,
               cand_gp, cand_remaining, under_cap, all_run_demand,
               all_run_gp, node_cap, free_by_node, cand_node) -> List[int]:
        return _preempt_until_fits(
            rng.permutation(len(cand_ids)), te_demand, cand_ids,
            cand_demand, cand_node, under_cap, free_by_node)

    def rank_key(self, rng, cand_demand, cand_gp, cand_remaining,
                 node_cap) -> np.ndarray:
        return rng.random(len(cand_gp))


register_policy(PolicySpec("fifo", preemptive=False, rule=FifoPolicy))
register_policy(PolicySpec("fitgpp", kind="score", score=fitgpp_score,
                           victim_from_pass=True, rule=FitGppPolicy))
register_policy(PolicySpec("minsize", kind="score", score=minsize_score,
                           rule=MinSizePolicy))
register_policy(PolicySpec("lrtp", kind="rank", rank=lrtp_rank,
                           rule=LrtpPolicy))
register_policy(PolicySpec("srtp", kind="rank", rank=srtp_rank,
                           rule=SrtpPolicy))
register_policy(PolicySpec("rand", kind="rank", rank=rand_rank,
                           rule=RandPolicy))

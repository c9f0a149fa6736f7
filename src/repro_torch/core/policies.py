"""Preemption decision rules: FitGpp (the paper, Eq. 1-4) + baselines.

A policy answers one question: given a TE job that does not fit
anywhere, which running BE job(s) should be signalled to vacate? Each
rule here mirrors the JAX package's ``jax_score`` / ``jax_rank``
declaration and is registered once in the port's policy table
(``core/policy_registry.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core.policy_registry import PolicySpec, register_policy
from repro_torch.kernels.schedule_step import size_eq1


def fitgpp_score(jobs, cand, node_cap, s):
    """Eq. 3: size/maxSize + s*GP/maxGP, normalizers over the running
    BE candidates (the paper's J), clamped at 1e-12.

    The engine reads fitgpp's victim from the fused schedule pass
    (``victim_from_pass``), which computes this same score; this plain
    form is the rule's declaration, held against the JAX package's
    ``jax_score`` by the tests."""
    sz = size_eq1(jobs.demand, node_cap)
    max_sz = torch.where(cand, sz, 0.0).max().clamp(min=1e-12)
    max_gp = torch.where(cand, jobs.gp, 0).max().float().clamp(min=1e-12)
    return sz / max_sz + s * (jobs.gp / max_gp)


def minsize_score(jobs, cand, node_cap, s):
    """Eq. 1 only: the FitGpp ablation without the grace-period term."""
    return size_eq1(jobs.demand, node_cap)


def lrtp_rank(st, jobs, gen):
    """Big-C's LRTP: longest remaining time preempted first."""
    return st.remaining.float()


def srtp_rank(st, jobs, gen):
    """Shortest remaining time preempted first."""
    return -st.remaining.float()


def rand_rank(st, jobs, gen):
    """Random victims: one uniform draw per job per selection."""
    return torch.rand(st.remaining.shape, generator=gen,
                      device=st.remaining.device)


register_policy(PolicySpec("fifo", preemptive=False))
register_policy(PolicySpec("fitgpp", kind="score", score=fitgpp_score,
                           victim_from_pass=True))
register_policy(PolicySpec("minsize", kind="score", score=minsize_score))
register_policy(PolicySpec("lrtp", kind="rank", rank=lrtp_rank))
register_policy(PolicySpec("srtp", kind="rank", rank=srtp_rank))
register_policy(PolicySpec("rand", kind="rank", rank=rand_rank))

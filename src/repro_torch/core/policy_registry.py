"""The port's policy table, keyed by registry name.

Each entry declares what the engine needs of a decision rule:

* ``preemptive`` — False runs TE and BE jobs in one FIFO queue;
* ``kind`` — ``"score"``: ``score(jobs, cand, node_cap, s) -> (N,)``,
  lower = better victim; the engine applies Eq. 2, the P cap, the Eq. 4
  masked argmin and the paper's random fallback. ``"rank"``:
  ``rank(state, jobs, uniform) -> (N,)``, higher = preempt first,
  consumed by the signal-until-the-TE-fits loop; ``uniform()`` draws
  one uniform per job from the engine's random source (a rank that
  calls it draws once a selection);
* ``victim_from_pass`` — the width-1 victim is read from the fused
  schedule pass (``kernels/ops.schedule_step``'s ``.victim``) instead
  of a plain masked argmin over ``score``, and a gang TE's victim
  scores from the same pass (``.scores``) over total gang demand;
* ``rule`` — the numpy reference engine's decision rule, a
  ``core/policies.Policy`` subclass; :func:`make` instantiates it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

_KINDS = (None, "rank", "score")


@dataclass(frozen=True)
class PolicySpec:
    name: str
    preemptive: bool = True
    kind: Optional[str] = None
    score: Optional[Callable] = None
    rank: Optional[Callable] = None
    victim_from_pass: bool = False
    rule: Optional[type] = None

    def make(self, s: Optional[float] = None):
        """Instantiate the reference decision rule (``s`` = Eq. 3 GP
        weight, the paper's by default)."""
        from repro_torch.configs.base import PAPER_S
        return self.rule(PAPER_S if s is None else float(s))


_REGISTRY: Dict[str, PolicySpec] = {}


def register_policy(spec: PolicySpec) -> PolicySpec:
    """Add ``spec`` to the table; a name registers once."""
    if spec.name in _REGISTRY:
        raise ValueError(f"policy {spec.name!r} already registered")
    if spec.kind not in _KINDS:
        raise ValueError(f"{spec.name!r}: kind must be one of {_KINDS}")
    if spec.preemptive and (spec.kind == "score") == (spec.score is None):
        raise ValueError(f"{spec.name!r}: a score policy needs score()")
    if spec.preemptive and (spec.kind == "rank") == (spec.rank is None):
        raise ValueError(f"{spec.name!r}: a rank policy needs rank()")
    if spec.rule is None or spec.rule.preemptive != spec.preemptive:
        raise ValueError(f"{spec.name!r}: needs a reference rule of the "
                         "same preemptiveness")
    _REGISTRY[spec.name] = spec
    return spec


def _ensure_populated() -> None:
    import repro_torch.core.policies  # noqa: F401  (registers the table)


def get_policy(name: str) -> PolicySpec:
    _ensure_populated()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; registered: "
                       f"{', '.join(sorted(_REGISTRY))}") from None


def make(name: str, s: Optional[float] = None):
    """The named policy's reference decision rule (what the numpy
    ``SchedulerCore`` calls), with Eq. 3 weight ``s``."""
    return get_policy(name).make(s)


def policy_names() -> List[str]:
    _ensure_populated()
    return sorted(_REGISTRY)


def validate_config(policy: str, s, P) -> None:
    """Fail fast (ValueError) on a config no engine could run."""
    _ensure_populated()
    if policy not in _REGISTRY:
        raise ValueError(f"unknown policy {policy!r}; known policies: "
                         f"{', '.join(sorted(_REGISTRY))}")
    try:
        s_ok = math.isfinite(float(s)) and float(s) >= 0.0
    except (TypeError, ValueError):
        s_ok = False
    if not s_ok:
        raise ValueError(f"s (Eq. 3 grace-period weight) must be a finite "
                         f"float >= 0, got {s!r}")
    try:
        p_ok = int(P) == P and int(P) >= 0
    except (TypeError, ValueError):
        p_ok = False
    if not p_ok:
        raise ValueError(f"max_preemptions (the paper's P cap) must be an "
                         f"integer >= 0, got {P!r}")

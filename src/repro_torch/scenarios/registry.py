"""Scenario registry: one namespace for every workload the port runs.

A *scenario* is any ``SimConfig -> JobSet`` function: synthetic
generators and trace adapters register through the same decorator:

    @register_scenario("te-flood", kind=SYNTHETIC,
                       knobs={"te_fraction": "share of TE jobs (0.85)"})
    def te_flood(cfg: SimConfig) -> JobSet:
        ...

Scenario functions honor ``cfg.workload.n_jobs`` (scale), ``cfg.seed``
(determinism) and ``cfg.cluster`` (capacities): ``build`` validates
every JobSet against the node shape before handing it out. The names,
kinds and knobs are those of the JAX package's registry.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.configs.cluster import SimConfig
from repro_torch.core.types import JobSet

SYNTHETIC = "synthetic"
TRACE = "trace"
_KINDS = (SYNTHETIC, TRACE)

ScenarioFn = Callable[[SimConfig], JobSet]


@dataclass(frozen=True)
class Scenario:
    name: str
    fn: ScenarioFn
    kind: str                          # SYNTHETIC | TRACE
    description: str                   # one line
    knobs: Tuple[Tuple[str, str], ...]  # (knob, meaning) pairs

    def build(self, cfg: SimConfig) -> JobSet:
        js = self.fn(cfg)
        js.validate(np.asarray(cfg.cluster.node.as_tuple()))
        return js


_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(name: str, *, kind: str = SYNTHETIC,
                      description: str = "",
                      knobs: Optional[Mapping[str, str]] = None):
    """Decorator registering ``fn`` as scenario ``name``.

    ``description`` defaults to the first line of the docstring; knobs
    document the tunable parameters (config fields or defaults)."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")

    def deco(fn: ScenarioFn) -> ScenarioFn:
        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} already registered")
        doc = (fn.__doc__ or "").strip().splitlines()
        desc = description or (doc[0] if doc else "")
        if not desc:
            raise ValueError(
                f"scenario {name!r} needs a description (pass "
                "description=... or give the function a docstring)")
        _REGISTRY[name] = Scenario(
            name=name, fn=fn, kind=kind, description=desc,
            knobs=tuple(sorted((knobs or {}).items())))
        return fn

    return deco


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY)) or "<none>"
        raise KeyError(f"unknown scenario {name!r}; registered: {known}") \
            from None


def scenario_names(kind: Optional[str] = None) -> List[str]:
    return sorted(n for n, sc in _REGISTRY.items()
                  if kind is None or sc.kind == kind)


def all_scenarios(kind: Optional[str] = None) -> List[Scenario]:
    return [_REGISTRY[n] for n in scenario_names(kind)]


def build(name: str, cfg: SimConfig) -> JobSet:
    """Build and validate the named scenario's JobSet for ``cfg``."""
    return get_scenario(name).build(cfg)


def get_source(name: str, cfg: SimConfig):
    """A scenario's job stream, for a streamed replay: the port has no
    stream engine yet (ROADMAP.md, queue 1: stream engine)."""
    get_scenario(name)
    raise NotImplementedError(
        f"scenario {name!r}: streamed replay needs the port's stream "
        "engine, which is not ported yet (stream engine, ROADMAP.md); "
        "build() gives the same jobs as one JobSet")

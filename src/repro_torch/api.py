"""The port's experiment facade: ``repro_torch.api``.

    from repro_torch import api
    r = api.run_experiment(policy="fitgpp", n_jobs=4096)   # on the GPU
    r.table["TE"]["p95"], r.preempted_frac, r.makespan

``run_experiment`` builds the config (validated against the port's
policy table), builds the scenario's ``JobSet`` (any name of
:func:`scenario_names`, gang widths and trace adapters included), runs
the PyTorch
engine on ``device`` (the current CUDA device unless the caller passes
one, e.g. ``device="cpu"``) and returns an :class:`ExperimentResult`
with the same fields as the JAX package's.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch import device as _device
from repro_torch import scenarios
from repro_torch.configs.cluster import SimConfig
from repro_torch.core import sim_torch
from repro_torch.core.types import JobSet
from repro_torch.kernels import ops

ENGINES = ("torch",)
DEFAULT_SCENARIO = "paper-synthetic"

scenario_names = scenarios.scenario_names


class RunOutput(NamedTuple):
    """Engine-native output of one run (``ExperimentResult.raw``)."""
    jobs: sim_torch.Jobs
    state: sim_torch.State
    iterations: int        # engine loop iterations
    acting_ticks: int      # iterations whose schedule pass ran
    seconds: float         # wall time of the engine loop (synchronized)
    launches: int          # schedule_step kernel launches in the run


@dataclass(frozen=True)
class ExperimentResult:
    """Result of one (scenario, policy, engine) run; ``table`` is the
    paper-style slowdown table (``{"TE": {"p50": ...}, "BE": {...}}``),
    ``intervals`` the preemption-to-resume percentiles, ``raw`` a
    :class:`RunOutput`."""
    scenario: str
    policy: str
    engine: str
    cfg: SimConfig
    table: Dict[str, Dict[str, float]]
    intervals: Dict[str, float]
    preempted_frac: float
    makespan: int
    raw: Any = field(repr=False, compare=False, default=None)
    events: Optional[list] = field(repr=False, compare=False, default=None)
    trace_overflow: int = 0
    fallback_count: int = 0


def make_config(policy: Optional[str] = None, *,
                base: Optional[SimConfig] = None,
                n_jobs: Optional[int] = None, n_nodes: Optional[int] = None,
                seed: Optional[int] = None, s: Optional[float] = None,
                P: Optional[int] = None,
                backfill: Optional[bool] = None) -> SimConfig:
    """SimConfig from the common experiment knobs (None keeps the
    ``base`` value, ``policy`` included)."""
    cfg = base if base is not None else SimConfig()
    repl: Dict[str, Any] = {}
    if policy is not None:
        repl["policy"] = policy
    if n_nodes is not None:
        repl["cluster"] = dataclasses.replace(cfg.cluster, n_nodes=n_nodes)
    if n_jobs is not None:
        repl["workload"] = dataclasses.replace(cfg.workload, n_jobs=n_jobs)
    if seed is not None:
        repl["seed"] = seed
    if s is not None:
        repl["s"] = s
    if P is not None:
        repl["max_preemptions"] = P
    if backfill is not None:
        repl["backfill"] = backfill
    return dataclasses.replace(cfg, **repl) if repl else cfg


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_experiment(scenario: str = DEFAULT_SCENARIO,
                   policy: Optional[str] = None,
                   engine: str = "torch", *,
                   cfg: Optional[SimConfig] = None,
                   jobs: Optional[JobSet] = None,
                   n_jobs: Optional[int] = None,
                   n_nodes: Optional[int] = None,
                   seed: Optional[int] = None,
                   s: Optional[float] = None,
                   P: Optional[int] = None,
                   backfill: Optional[bool] = None,
                   mode: Optional[str] = None,
                   device=None) -> ExperimentResult:
    """Run one (scenario, policy) experiment on the PyTorch engine.

    ``jobs`` short-circuits the scenario build (to share one JobSet
    across policies); ``mode`` ("event" | "tick", default
    ``cfg.time_mode``) selects the time advancement (bit-identical
    results); ``backfill`` switches the bounded first-fit BE backfill;
    ``device`` defaults to the current CUDA device and raises without
    one."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    if mode not in (None, "event", "tick"):
        raise ValueError(f"unknown mode {mode!r}; one of ('event', 'tick')")
    dev = _device.resolve(device)
    cfg = make_config(policy, base=cfg, n_jobs=n_jobs, n_nodes=n_nodes,
                      seed=seed, s=s, P=P, backfill=backfill)
    mode = cfg.time_mode if mode is None else mode
    js = scenarios.build(scenario, cfg) if jobs is None else jobs
    tj = sim_torch.jobs_from_jobset(js, dev)
    stats: Dict[str, int] = {}
    launches0 = ops.LAUNCHES["schedule_step"]
    _synchronize(dev)
    t0 = time.perf_counter()
    st = sim_torch.run(cfg, tj, cfg.seed, time_mode=mode, stats=stats)
    _synchronize(dev)
    seconds = time.perf_counter() - t0
    summary = sim_torch.result_summary(tj, st)
    raw = RunOutput(tj, st, stats["iterations"], stats["acting_ticks"],
                    seconds,
                    ops.LAUNCHES["schedule_step"] - launches0)
    return ExperimentResult(
        scenario=scenario, policy=cfg.policy, engine=engine, cfg=cfg,
        table={k: summary[k] for k in ("TE", "BE")},
        intervals=summary["intervals"],
        preempted_frac=summary["preempted_frac"], makespan=int(st.t),
        raw=raw, fallback_count=int(summary["fallback_count"]))


def compare_policies(policies, scenario: str = DEFAULT_SCENARIO,
                     engine: str = "torch",
                     **kw) -> Dict[str, ExperimentResult]:
    """Run several policies on ONE shared JobSet (Table 1 shape), built
    once from the first policy's config."""
    policies = list(policies)
    _device.resolve(kw.get("device"))     # fail before the build
    cfg0 = make_config(policies[0], base=kw.get("cfg"),
                       n_jobs=kw.get("n_jobs"), n_nodes=kw.get("n_nodes"),
                       seed=kw.get("seed"))
    js = scenarios.build(scenario, cfg0)
    return {p: run_experiment(scenario, p, engine, jobs=js, **kw)
            for p in policies}

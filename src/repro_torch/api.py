"""The port's experiment facade: ``repro_torch.api``.

    from repro_torch import api
    r = api.run_experiment(policy="fitgpp", n_jobs=4096)   # on the GPU
    r.table["TE"]["p95"], r.preempted_frac, r.makespan

``run_experiment`` builds the config (validated against the port's
policy table), builds the scenario's ``JobSet`` (any name of
:func:`scenario_names`, gang widths and trace adapters included), runs
one of two engines and returns an :class:`ExperimentResult` with the
same fields as the JAX package's:

* ``engine="torch"`` (the default): the PyTorch engine on ``device``
  (the current CUDA device unless the caller passes one, e.g.
  ``device="cpu"``);
* ``engine="reference"``: the host numpy reference engine
  (``core/simulator.py``), which never touches a GPU.

``trace=True`` records the canonical event stream into ``.events``
(``obs.schema.Event`` rows) on either engine; write it with
``obs.export.write_trace`` (Perfetto JSON or CSV) or replay it with
``obs.timeseries``.

:func:`run_stream` replays a scenario through the stream engine
(``core/stream``) on ``device``: a pool of ``capacity`` job slots, so
device memory scales with the pool and not with the trace, with the
monolithic engine's results (``engine="stream"`` on the result).

Batched studies go through the same module: :func:`sensitivity_grid`,
:func:`scenario_sweep` and :func:`run_sweep` (``core/sweep.py``) and
:func:`run_table` / :func:`build_table` / :func:`pooled_tables`, the
sweep fabric underneath them (``core/sweep_fabric.py``): one trial
table, every trial of a grid in one batched engine run
(``core/sim_batch.py``) on ``device`` (the current CUDA device unless
the caller passes one). :func:`mesh_for_sweep` names the devices a
sweep uses: one by default, or with ``devices=N`` N shards of the
table, one process each (``sharding/trials.py``).
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
from repro_torch.core import metrics, sim_torch, simulator
from repro_torch.core.policy_registry import get_policy, policy_names
from repro_torch.core.sweep import run_sweep, scenario_sweep, sensitivity_grid
from repro_torch.core.sweep_fabric import (SweepResult, TrialTable,
                                           build_table, pooled_tables,
                                           run_table)
from repro_torch.core.types import JobSet
from repro_torch.kernels import ops
from repro_torch.launch.mesh import mesh_for_sweep

ENGINES = ("torch", "reference")
DEFAULT_SCENARIO = "paper-synthetic"

__all__ = [
    "DEFAULT_SCENARIO", "ENGINES", "ExperimentResult", "RunOutput",
    "SweepResult", "TrialTable", "build_table", "compare_policies",
    "get_policy", "make_config", "mesh_for_sweep", "policy_names",
    "pooled_tables", "run_experiment", "run_stream", "run_sweep",
    "run_table",
    "scenario_names", "scenario_sweep", "sensitivity_grid",
]

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
    :class:`RunOutput` (torch engine) or the ``SimResult`` (reference
    engine). ``events`` is the event stream of a traced run (else
    None); ``trace_overflow`` the rows a torch run's ring dropped (0: a
    complete trace; the reference never drops); ``engine`` is "stream"
    and ``raw`` a ``StreamResult`` for :func:`run_stream`;
    ``fallback_count`` the
    torch engine's random-fallback and over-cap selections, or the
    reference engine's random fallbacks of a score rule."""
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


def _run_reference(scenario: str, cfg: SimConfig, js: JobSet, mode: str,
                   trace: bool) -> ExperimentResult:
    sim = simulator.Simulator(cfg, js, trace=trace)
    res = sim.run(mode=mode)
    return ExperimentResult(
        scenario=scenario, policy=cfg.policy, engine="reference", cfg=cfg,
        table=metrics.slowdown_table(res),
        intervals=metrics.resched_table(res),
        preempted_frac=res.preempted_fraction(),
        makespan=int(res.makespan), raw=res, events=res.trace,
        fallback_count=sim.policy.fallback_count)


def _run_torch(scenario: str, cfg: SimConfig, js: JobSet, mode: str,
               trace: bool, trace_capacity: Optional[int],
               dev: torch.device) -> ExperimentResult:
    tj = sim_torch.jobs_from_jobset(js, dev)
    stats: Dict[str, int] = {}
    launches0 = ops.LAUNCHES["schedule_step"]
    _synchronize(dev)
    t0 = time.perf_counter()
    st = sim_torch.run(cfg, tj, cfg.seed, time_mode=mode, stats=stats,
                       trace=trace, trace_capacity=trace_capacity)
    _synchronize(dev)
    seconds = time.perf_counter() - t0
    summary = sim_torch.result_summary(tj, st)
    raw = RunOutput(tj, st, stats["iterations"], stats["acting_ticks"],
                    seconds,
                    ops.LAUNCHES["schedule_step"] - launches0)
    return ExperimentResult(
        scenario=scenario, policy=cfg.policy, engine="torch", cfg=cfg,
        table={k: summary[k] for k in ("TE", "BE")},
        intervals=summary["intervals"],
        preempted_frac=summary["preempted_frac"], makespan=int(st.t),
        raw=raw, events=sim_torch.decode_trace(st)[0] if trace else None,
        trace_overflow=int(summary["trace_overflow"]),
        fallback_count=int(summary["fallback_count"]))


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
                   trace: bool = False,
                   trace_capacity: Optional[int] = None,
                   device=None) -> ExperimentResult:
    """Run one (scenario, policy) experiment on the chosen engine.

    ``engine="torch"`` runs the PyTorch engine on ``device``, which
    defaults to the current CUDA device and raises without one (pass
    ``device="cpu"`` for the plain path on the CPU).
    ``engine="reference"`` runs the host numpy reference engine: it
    never touches a GPU, and passing a ``device`` with it raises.

    ``jobs`` short-circuits the scenario build (to share one JobSet
    across policies); ``mode`` ("event" | "tick", default
    ``cfg.time_mode``) selects the time advancement on either engine
    (bit-identical results); ``backfill`` switches the bounded
    first-fit BE backfill.

    ``trace=True`` records the canonical scheduler-event stream
    (``obs.schema.Event``) into ``.events``: through the simulator's hooks
    on the reference engine, through the State's ring on the torch
    engine (decoded after the run; ``trace_capacity`` overrides the
    ring's size, ``obs.ring.default_capacity`` by default, and
    ``.trace_overflow`` counts the rows it dropped). The reference
    engine has no ring and raises if given a ``trace_capacity``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    if mode not in (None, "event", "tick"):
        raise ValueError(f"unknown mode {mode!r}; one of ('event', 'tick')")
    if engine == "reference" and device is not None:
        raise ValueError("the reference engine runs on the host only; "
                         f"got device={device!r}")
    if engine == "reference" and trace_capacity is not None:
        raise ValueError("the reference engine records its trace without "
                         "a ring; got trace_capacity="
                         f"{trace_capacity!r}")
    dev = _device.resolve(device) if engine == "torch" else None
    cfg = make_config(policy, base=cfg, n_jobs=n_jobs, n_nodes=n_nodes,
                      seed=seed, s=s, P=P, backfill=backfill)
    mode = cfg.time_mode if mode is None else mode
    js = scenarios.build(scenario, cfg) if jobs is None else jobs
    if engine == "reference":
        return _run_reference(scenario, cfg, js, mode, trace)
    return _run_torch(scenario, cfg, js, mode, trace, trace_capacity, dev)


def run_stream(scenario: str = DEFAULT_SCENARIO,
               policy: Optional[str] = None, *,
               cfg: Optional[SimConfig] = None,
               source=None,
               capacity: Optional[int] = None,
               n_jobs: Optional[int] = None,
               n_nodes: Optional[int] = None,
               seed: Optional[int] = None,
               mode: Optional[str] = None,
               trace: bool = False,
               trace_capacity: Optional[int] = None,
               admission=None,
               device=None) -> ExperimentResult:
    """Replay a scenario through the stream engine (``core/stream``):
    bounded memory, any trace length, the results of
    ``engine="torch"`` on the same workload.

    Runs on ``device`` as :func:`run_experiment`'s torch engine does
    (the current CUDA device unless ``device`` is given, e.g. "cpu").
    The workload comes from the scenario's registered streaming
    ``source`` (trace readers, chunked generators; other scenarios
    stream a chunked view of the built JobSet), or from an explicit
    ``source`` (a ``core.stream.JobSource``). ``capacity`` bounds the
    jobs in flight (default ``stream.default_capacity(cfg)``).
    ``admission`` turns on closed-loop arrivals (paper §4.2): the
    source's submit times become admit ticks holding the
    FIFO-normalized backlog at ``cfg.workload.load``
    (``admission=True``) or at an explicit float target. ``.raw`` is
    the :class:`repro_torch.core.stream.StreamResult` (per-job arrays,
    rounds, peak live jobs, spill counters); ``.events`` the stream
    remapped to global job ids when traced."""
    from repro_torch.core import stream
    if mode not in (None, "event", "tick"):
        raise ValueError(f"unknown mode {mode!r}; one of ('event', 'tick')")
    dev = _device.resolve(device)
    cfg = make_config(policy, base=cfg, n_jobs=n_jobs, n_nodes=n_nodes,
                      seed=seed)
    mode = cfg.time_mode if mode is None else mode
    if source is None:
        source = scenarios.get_source(scenario, cfg)
    res = stream.StreamEngine(cfg, source, capacity=capacity,
                              time_mode=mode, trace=trace,
                              trace_capacity=trace_capacity,
                              admission=admission, device=dev).run()
    summary = res.summary()
    return ExperimentResult(
        scenario=scenario, policy=cfg.policy, engine="stream", cfg=cfg,
        table={k: summary[k] for k in ("TE", "BE")},
        intervals=summary["intervals"],
        preempted_frac=summary["preempted_frac"], makespan=res.makespan,
        raw=res, events=res.events, trace_overflow=res.trace_overflow,
        fallback_count=res.fallback_count)


def compare_policies(policies, scenario: str = DEFAULT_SCENARIO,
                     engine: str = "torch",
                     **kw) -> Dict[str, ExperimentResult]:
    """Run several policies on ONE shared JobSet (Table 1 shape), built
    once from the first policy's config."""
    policies = list(policies)
    if engine == "torch":
        _device.resolve(kw.get("device"))     # fail before the build
    cfg0 = make_config(policies[0], base=kw.get("cfg"),
                       n_jobs=kw.get("n_jobs"), n_nodes=kw.get("n_nodes"),
                       seed=kw.get("seed"))
    js = scenarios.build(scenario, cfg0)
    return {p: run_experiment(scenario, p, engine, jobs=js, **kw)
            for p in policies}

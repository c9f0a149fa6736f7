"""Public GPU-cluster trace adapters -> validated :class:`JobSet` (the
port's copy of the JAX package's ``scenarios/traces.py``: the same
parsing rules, drop counts and arrays; the port reads its own copies
of the bundled fixtures).

Two CSV dialects are supported, modelled on the public traces the
related schedulers evaluate on (DL2, arXiv:1909.06040; prediction-
assisted scheduling, arXiv:2501.05563):

* **Philly-style** (Microsoft Philly job log flattened to CSV):
  ``jobid,vc,submit_time,start_time,end_time,gpus,status`` with
  ISO-8601 or epoch-second timestamps and a whole-job GPU count.
  Philly publishes no CPU/RAM requests, so those are estimated
  pro-rata to the job's GPU share of a node (half-GPU floor).
* **Alibaba-PAI-style** (pai_task_table):
  ``job_name,task_name,inst_num,status,start_time,end_time,
  plan_cpu,plan_mem,plan_gpu`` with epoch-second timestamps,
  ``plan_cpu``/``plan_gpu`` in percent (100 = 1 core / 1 GPU),
  ``plan_mem`` in GB and ``inst_num`` gang instances. The task table
  records no queueing, so ``start_time`` doubles as the submit time.

Shared normalization (the adapter contract, DESIGN.md §5):

* rows with unparseable fields, a missing/negative runtime, or a gang
  wider than the cluster are dropped (counted in ``TraceStats``);
* times rebase to minute 0 at the earliest submit; ``time_scale``
  compresses gaps (a months-long trace replays in a tractable horizon);
* demand snaps to node quanta: GPUs to ``cfg.workload.gpu_quanta``,
  CPU/RAM to whole units, everything clipped to the node capacity;
* gang width: Philly jobs wider than one node split into
  ``ceil(gpus / node.gpu)`` equal instances; PAI uses ``inst_num``;
* TE/BE: runtime <= ``te_runtime_min`` is TE (the paper's TE class is
  short trial runs; its §4.2 truncation, 30 min, is the default);
* grace periods are not recorded in public traces — they are sampled
  from ``cfg.workload.scaled_gp()`` under ``cfg.seed`` (deterministic).

Every dialect has two entry points over the SAME row parser:

* ``load_*_csv`` — one monolithic, globally-sorted JobSet (rows may
  arrive in any order; gp drawn once under ``(seed, 0xB07)``);
* :func:`iter_trace_csv` — a one-pass streaming reader: yields
  normalized JobSet chunks holding O(chunk) rows, requires the CSV be
  submit-ordered, and draws gp per chunk under
  ``(seed, 0xB07, chunk_idx)`` — so a streamed replay's grace periods
  differ from the monolithic loader's, but are deterministic given
  the chunk size.

:func:`tiled_trace_chunks` tiles a bundled fixture end-to-end K times
with time offsets — a public-log-length stream from a few-KB file.
"""
from __future__ import annotations

import csv
import math
import os
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.cluster import SimConfig
from repro_torch.core import workload
from repro_torch.core.stream.source import JobSource, materialize
from repro_torch.core.types import JobSet
from repro_torch.scenarios.registry import TRACE, register_scenario

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
PHILLY_SAMPLE = os.path.join(FIXTURE_DIR, "philly_sample.csv")
PAI_SAMPLE = os.path.join(FIXTURE_DIR, "pai_sample.csv")


@dataclass
class TraceStats:
    """What the adapter kept and why it dropped the rest."""
    n_rows: int = 0
    n_jobs: int = 0
    n_malformed: int = 0
    n_zero_runtime: int = 0
    n_too_wide: int = 0
    n_filtered_status: int = 0


def _parse_ts(raw: str) -> float:
    """Epoch seconds from an ISO-8601 or numeric timestamp."""
    raw = raw.strip()
    if not raw:
        raise ValueError("empty timestamp")
    try:
        return float(raw)
    except ValueError:
        dt = datetime.fromisoformat(raw)
        if dt.tzinfo is None:              # naive stamps read as UTC
            dt = dt.replace(tzinfo=timezone.utc)
        return dt.timestamp()


# One parsed row: (submit_sec, exec_min, (cpu, ram, gpu), gang_width).
# Parsers return this tuple, or the TraceStats counter name to bump
# when the row is dropped — the single definition of each dialect,
# shared by the monolithic loaders and the streaming reader.
_Row = Tuple[float, int, Tuple[float, float, float], int]


def _philly_row(row, cfg: SimConfig):
    node = cfg.cluster.node
    try:
        sub = _parse_ts(row["submit_time"])
        start = _parse_ts(row["start_time"])
        end = _parse_ts(row["end_time"])
        gpus = float(row["gpus"])
    except (KeyError, ValueError, TypeError):
        return "n_malformed"
    runtime_min = math.ceil((end - start) / 60.0)
    if runtime_min <= 0 or start < sub or gpus < 0:
        return "n_zero_runtime"
    width = max(1, math.ceil(gpus / node.gpu))
    if width > cfg.cluster.n_nodes:
        return "n_too_wide"
    gpu_pn = gpus / width
    # Philly has no CPU/RAM requests: estimate pro-rata to the GPU
    # share of a node, with a half-GPU floor for CPU-only
    share = max(gpu_pn, 0.5) / node.gpu
    return (sub, runtime_min,
            (node.cpu * share, node.ram * share, gpu_pn), width)


def _pai_row(row, cfg: SimConfig):
    try:
        start = _parse_ts(row["start_time"])
        end = _parse_ts(row["end_time"])
        inst = int(float(row["inst_num"]))
        cpu = float(row["plan_cpu"]) / 100.0
        ram = float(row["plan_mem"])
        gpu = float(row["plan_gpu"]) / 100.0
    except (KeyError, ValueError, TypeError):
        return "n_malformed"
    runtime_min = math.ceil((end - start) / 60.0)
    if runtime_min <= 0 or inst < 1 or min(cpu, ram, gpu) < 0:
        return "n_zero_runtime"
    if inst > cfg.cluster.n_nodes:
        return "n_too_wide"
    # the task table records no queueing: start doubles as submit
    return (start, runtime_min, (cpu, ram, gpu), inst)


DIALECTS = {"philly": _philly_row, "pai": _pai_row}


def _iter_parsed(path: str, parser, cfg: SimConfig, stats: TraceStats,
                 statuses: Optional[Sequence[str]]) -> Iterator[_Row]:
    """One pass over the CSV: parsed rows out, drops counted."""
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            stats.n_rows += 1
            if statuses is not None and row.get("status") not in statuses:
                stats.n_filtered_status += 1
                continue
            out = parser(row, cfg)
            if isinstance(out, str):
                setattr(stats, out, getattr(stats, out) + 1)
                continue
            stats.n_jobs += 1
            yield out


def _snap_demand(cfg: SimConfig, demand: np.ndarray,
                 node_cap: np.ndarray) -> np.ndarray:
    """Demand snapping: GPUs to the allocation quanta, CPU/RAM to
    whole units; everything clipped to a node."""
    demand[:, 0] = np.clip(np.round(demand[:, 0]), 1.0, node_cap[0])
    demand[:, 1] = np.clip(np.round(demand[:, 1]), 1.0, node_cap[1])
    demand[:, 2] = np.clip(
        workload.snap(demand[:, 2], cfg.workload.gpu_quanta),
        0.0, node_cap[2])
    return demand


def _finalize(cfg: SimConfig, submit_min, exec_min, demand, n_nodes,
              te_runtime_min: float) -> JobSet:
    """Shared monolithic tail: snap/clip demand, classify, sample GPs,
    sort globally."""
    node_cap = np.asarray(cfg.cluster.node.as_tuple())
    submit = np.asarray(submit_min, np.int64)
    exec_total = np.maximum(np.asarray(exec_min, np.int64), 1)
    demand = _snap_demand(
        cfg, np.asarray(demand, np.float64).reshape(-1, 3), node_cap)
    n_nodes = np.asarray(n_nodes, np.int64)
    n = len(submit)

    is_te = exec_total <= te_runtime_min
    rng = np.random.default_rng((cfg.seed, 0xB07))
    gp = np.round(workload.sample_trunc_normal(
        rng, cfg.workload.scaled_gp(), n)).astype(np.int64)

    if n == 0:
        raise ValueError(
            "trace produced no usable jobs (every row malformed, "
            "zero-runtime, status-filtered or wider than the cluster)")
    order = np.argsort(submit, kind="stable")
    submit = submit[order] - submit.min()
    js = JobSet(submit=submit, exec_total=exec_total[order],
                demand=demand[order], is_te=is_te[order], gp=gp[order],
                n_nodes=n_nodes[order])
    js.validate(node_cap)
    return js


def _load_csv(path: str, cfg: SimConfig, dialect: str, *,
              te_runtime_min: float, time_scale: float,
              statuses: Optional[Sequence[str]], return_stats: bool):
    stats = TraceStats()
    submit_min, exec_min, demand, n_nodes = [], [], [], []
    for sub, rt, dem, width in _iter_parsed(
            path, DIALECTS[dialect], cfg, stats, statuses):
        submit_min.append(sub / 60.0 / time_scale)
        exec_min.append(rt)
        demand.append(dem)
        n_nodes.append(width)
    js = _finalize(cfg, np.floor(submit_min), exec_min, demand, n_nodes,
                   te_runtime_min)
    return (js, stats) if return_stats else js


def load_philly_csv(path: str, cfg: SimConfig, *,
                    te_runtime_min: float = 30.0, time_scale: float = 1.0,
                    statuses: Optional[Sequence[str]] = None,
                    return_stats: bool = False):
    """Philly-style CSV -> JobSet (see module docstring for the dialect).

    ``statuses`` restricts to the given job outcomes (default: keep all
    — Killed/Failed jobs consumed resources too). ``return_stats`` also
    returns the :class:`TraceStats` drop accounting.
    """
    return _load_csv(path, cfg, "philly", te_runtime_min=te_runtime_min,
                     time_scale=time_scale, statuses=statuses,
                     return_stats=return_stats)


def load_pai_csv(path: str, cfg: SimConfig, *,
                 te_runtime_min: float = 30.0, time_scale: float = 1.0,
                 statuses: Optional[Sequence[str]] = None,
                 return_stats: bool = False):
    """Alibaba-PAI-style CSV -> JobSet (dialect in the module docstring).

    ``plan_cpu`` / ``plan_gpu`` are percentages (100 = 1 core / 1 GPU),
    ``plan_mem`` is GB, ``inst_num`` is the gang width.
    """
    return _load_csv(path, cfg, "pai", te_runtime_min=te_runtime_min,
                     time_scale=time_scale, statuses=statuses,
                     return_stats=return_stats)


def iter_trace_csv(path: str, cfg: SimConfig, dialect: str = "philly", *,
                   chunk: int = 4096, te_runtime_min: float = 30.0,
                   time_scale: float = 1.0,
                   statuses: Optional[Sequence[str]] = None,
                   stats: Optional[TraceStats] = None
                   ) -> Iterator[JobSet]:
    """One-pass streaming trace reader: normalized, validated JobSet
    chunks of up to ``chunk`` rows — never the whole trace in memory.

    The CSV must already be submit-ordered (public trace dumps are;
    an out-of-order row raises — a global sort needs the full trace,
    which is exactly what streaming avoids, so unsorted files must go
    through the monolithic ``load_*_csv``). Times rebase to the FIRST
    kept row (== the global minimum when sorted). Grace periods draw
    per chunk from ``rng((cfg.seed, 0xB07, chunk_idx))``, so the
    stream is reproducible given ``chunk`` but its gp values differ
    from the monolithic loader's single draw. ``stats`` (a
    :class:`TraceStats`) fills in-place as the pass advances — drop
    accounting comes for free with the same read.
    """
    wl = cfg.workload
    node_cap = np.asarray(cfg.cluster.node.as_tuple())
    stats = TraceStats() if stats is None else stats
    t0: Optional[int] = None
    last_submit: Optional[int] = None
    k = 0
    buf: list = []

    def emit() -> JobSet:
        nonlocal k, last_submit
        sub_sec = np.array([r[0] for r in buf], np.float64)
        submit = np.floor(sub_sec / 60.0 / time_scale).astype(np.int64)
        if (np.diff(submit) < 0).any() or (
                last_submit is not None and int(submit[0]) < last_submit):
            raise ValueError(
                f"{path}: rows are not submit-ordered; the streaming "
                "reader cannot globally sort — use the monolithic "
                f"load_{dialect}_csv for unsorted traces")
        last_submit = int(submit[-1])
        exec_total = np.maximum(
            np.array([r[1] for r in buf], np.int64), 1)
        demand = _snap_demand(
            cfg, np.array([r[2] for r in buf], np.float64).reshape(-1, 3),
            node_cap)
        rng = np.random.default_rng((cfg.seed, 0xB07, k))
        gp = np.round(workload.sample_trunc_normal(
            rng, wl.scaled_gp(), len(buf))).astype(np.int64)
        js = JobSet(submit=submit - t0,
                    exec_total=exec_total, demand=demand,
                    is_te=exec_total <= te_runtime_min, gp=gp,
                    n_nodes=np.array([r[3] for r in buf], np.int64))
        js.validate(node_cap)
        k += 1
        return js

    for parsed in _iter_parsed(path, DIALECTS[dialect], cfg, stats,
                               statuses):
        if t0 is None:
            t0 = int(math.floor(parsed[0] / 60.0 / time_scale))
        buf.append(parsed)
        if len(buf) >= chunk:
            yield emit()
            buf = []
    if buf:
        yield emit()


def trace_source(path: str, cfg: SimConfig, dialect: str = "philly",
                 **kw) -> JobSource:
    """:class:`JobSource` over :func:`iter_trace_csv` with the drop
    accounting attached (``source.stats``) for one-pass consumers."""
    stats = TraceStats()
    return JobSource(
        iter_trace_csv(path, cfg, dialect, stats=stats, **kw),
        stats=stats)


def tiled_trace_chunks(path: str, cfg: SimConfig, dialect: str = "philly",
                       *, repeats: Optional[int] = None, gap_min: int = 1,
                       te_runtime_min: float = 30.0,
                       time_scale: float = 1.0,
                       statuses: Optional[Sequence[str]] = None
                       ) -> Iterator[JobSet]:
    """Tile a small fixture trace end-to-end ``repeats`` times with
    time offsets — a public-log-length stream from a bundled file,
    O(fixture) memory. Each repeat shifts by the fixture's submit
    span plus its longest runtime (so steady state drains between
    tiles) plus ``gap_min``, and resamples grace periods under
    ``rng((cfg.seed, 0xB07, repeat))``. ``repeats`` defaults to
    whatever reaches ``cfg.workload.n_jobs`` total jobs."""
    base = _load_csv(path, cfg, dialect, te_runtime_min=te_runtime_min,
                     time_scale=time_scale, statuses=statuses,
                     return_stats=False)
    if repeats is None:
        repeats = max(1, -(-int(cfg.workload.n_jobs) // base.n))
    span = int(base.submit[-1]) + int(base.exec_total.max()) + int(gap_min)
    for r in range(int(repeats)):
        rng = np.random.default_rng((cfg.seed, 0xB07, r))
        gp = np.round(workload.sample_trunc_normal(
            rng, cfg.workload.scaled_gp(), base.n)).astype(np.int64)
        yield JobSet(submit=base.submit + r * span,
                     exec_total=base.exec_total, demand=base.demand,
                     is_te=base.is_te, gp=gp, n_nodes=base.n_nodes)


def tiled_source(path: str, cfg: SimConfig, dialect: str = "philly",
                 **kw) -> JobSource:
    """:class:`JobSource` over :func:`tiled_trace_chunks`."""
    return JobSource(tiled_trace_chunks(path, cfg, dialect, **kw))


@register_scenario(
    "philly-sample", kind=TRACE,
    knobs={"te_runtime_min": "TE/BE runtime threshold, minutes (30)",
           "time_scale": "arrival-gap compression factor (1.0)",
           "statuses": "job outcomes to keep (all)"},
    source=lambda cfg: trace_source(PHILLY_SAMPLE, cfg, "philly"))
def philly_sample(cfg: SimConfig) -> JobSet:
    """Bundled Microsoft-Philly-style sample trace (fixtures/, no network)."""
    return load_philly_csv(PHILLY_SAMPLE, cfg)


@register_scenario(
    "pai-sample", kind=TRACE,
    knobs={"te_runtime_min": "TE/BE runtime threshold, minutes (30)",
           "time_scale": "arrival-gap compression factor (1.0)",
           "statuses": "task outcomes to keep (all)"},
    source=lambda cfg: trace_source(PAI_SAMPLE, cfg, "pai"))
def pai_sample(cfg: SimConfig) -> JobSet:
    """Bundled Alibaba-PAI-style sample trace (fixtures/, no network)."""
    return load_pai_csv(PAI_SAMPLE, cfg)


def _philly_tiled_source(cfg: SimConfig) -> JobSource:
    return tiled_source(PHILLY_SAMPLE, cfg, "philly")


@register_scenario(
    "philly-tiled", kind=TRACE,
    knobs={"repeats": "fixture tilings (auto: reach workload.n_jobs)",
           "gap_min": "idle gap between tiles, minutes (1)"},
    source=_philly_tiled_source)
def philly_tiled(cfg: SimConfig) -> JobSet:
    """Philly sample tiled end-to-end to ~``workload.n_jobs`` jobs.

    The repeated-fixture long trace: a public-log-length workload from
    the bundled few-KB fixture. It streams through ``core/stream`` in
    bounded memory; this entry materializes the same stream for the
    monolithic engines."""
    return materialize(_philly_tiled_source(cfg))


def _pai_tiled_source(cfg: SimConfig) -> JobSource:
    return tiled_source(PAI_SAMPLE, cfg, "pai")


@register_scenario(
    "pai-tiled", kind=TRACE,
    knobs={"repeats": "fixture tilings (auto: reach workload.n_jobs)",
           "gap_min": "idle gap between tiles, minutes (1)"},
    source=_pai_tiled_source)
def pai_tiled(cfg: SimConfig) -> JobSet:
    """PAI sample tiled end-to-end to ~``workload.n_jobs`` jobs.

    Same construction as ``philly-tiled`` over the Alibaba-PAI-style
    fixture (gang instances included)."""
    return materialize(_pai_tiled_source(cfg))

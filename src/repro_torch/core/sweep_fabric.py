"""The port's sweep fabric: one trial table for a whole (scenario ×
policy × seed × s × P) grid, run by the batched engine
(``core/sim_batch.py``) in one lockstep loop on one device.

The counterpart of the JAX package's ``core/sweep_fabric.py``, with its
names, its summaries key for key and its sentinel contract:

    table = sweep_fabric.build_table(jobsets, s_vals, P_vals, seeds)
    res = sweep_fabric.run_table(cfg, table)          # on the card
    res.stats["te_slowdown"]                          # (T, 3) ndarray

A trial table is stacked ``Jobs`` plus per-trial ``s`` / ``P`` /
``seed`` vectors. Ragged job counts are padded with sentinel jobs
(``valid=False``, born DONE, masked out of every summary); a table can
be padded with sentinel trials (every job a sentinel: done at iteration
0, all-nan summaries), which ``run_table`` drops before returning.
Tables are built on the host (CPU tensors); ``run_table`` moves one to
``device``, the current CUDA device unless the caller passes one
(``device="cpu"`` runs the plain PyTorch path).

Axis contract, as in the JAX module: ``policy`` and every other
``SimConfig`` field is static, one ``run_table`` call per config;
``s`` / ``P`` / ``seed`` are per-trial inputs. A trial's result does
not depend on the other trials of its table (``sim_batch``'s
counter-based draws), so a multi-policy grid is one call per policy
over the same table.

Two parts of the JAX module are JAX machinery with no counterpart in
eager PyTorch, and are not ported: buffer donation (``donate``, XLA
aliasing the table's buffers into a compiled program) and
``compile_stats`` (the cache of jitted runners; eager PyTorch compiles
nothing per config). In their place ``SweepResult.engine_stats`` holds
the batched engine's counters (iterations, host reads, schedule passes,
kernel launches). The port runs a table on one device: sharding its
trials over several (the JAX ``shard_map`` over ``mesh_for_sweep``'s
mesh, ``sharding/trials.py``) is a later item, multi-device sweeps, and
``launch.mesh.mesh_for_sweep`` raises for a request that would use
more than one device.

``core/sweep.py`` (``run_sweep`` / ``sensitivity_grid`` /
``scenario_sweep``) is a thin wrapper over this module; callers reach
both through ``repro_torch.api``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.cluster import SimConfig
from repro_torch.core import metrics, sim_batch, sim_torch
from repro_torch.core.sim_torch import Jobs
from repro_torch.core.types import JobSet
from repro_torch.launch.mesh import mesh_for_sweep

__all__ = [
    "SweepResult", "TrialTable", "build_table", "pad_jobs", "pad_table",
    "pooled_tables", "run_table", "stack_jobsets", "table_from_stacked",
]

F32 = torch.float32
# the fill of each Jobs field in a sentinel row: zero demand, unit
# execution, width 1, never valid
_SENTINEL = {"submit": 0, "exec_total": 1, "demand": 0.0, "is_te": False,
             "gp": 0, "width": 1, "valid": False}


# ---------------------------------------------------------------- jobs

def _extend(jobs: Jobs, pad: int) -> Jobs:
    """``jobs`` with ``pad`` sentinel rows appended on its leading axis."""
    def ext(name):
        x = getattr(jobs, name)
        tail = torch.full((pad,) + tuple(x.shape[1:]), _SENTINEL[name],
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, tail])

    return Jobs(**{name: ext(name) for name in _SENTINEL})


def pad_jobs(jobs: Jobs, n_max: int) -> Jobs:
    """Pad one trial's Jobs to ``n_max`` rows with sentinel jobs (zero
    demand, unit execution, ``width=1``, ``valid=False``): born DONE,
    they never arrive, queue, run or become preemption candidates, and
    every per-trial summary masks them out. Real rows keep their gang
    widths."""
    pad = n_max - jobs.submit.shape[0]
    if pad < 0:
        raise ValueError(f"cannot pad {jobs.submit.shape[0]} jobs "
                         f"down to {n_max}")
    return jobs if pad == 0 else _extend(jobs, pad)


def stack_jobsets(jobsets: Sequence[JobSet]) -> Jobs:
    """Stack workloads over a leading trial axis (CPU tensors). Ragged
    collections are padded to the largest ``n`` with sentinel jobs
    (:func:`pad_jobs`); gang widths (``JobSet.n_nodes`` ->
    ``Jobs.width``) ride through, sentinel rows stay width 1."""
    js = [sim_torch.jobs_from_jobset(j, "cpu") for j in jobsets]
    n_max = max(j.submit.shape[0] for j in js)
    js = [pad_jobs(j, n_max) for j in js]
    return Jobs(**{name: torch.stack([getattr(j, name) for j in js])
                   for name in _SENTINEL})


# --------------------------------------------------------- trial table

class TrialTable(NamedTuple):
    """The flattened sweep grid: trial t runs ``jobs[t]`` under
    ``(s[t], P[t], seed[t])``. ``n_valid`` counts the real trials; rows
    past it (appended by :func:`pad_table`) are sentinel trials, every
    job ``valid=False``, done before their first iteration."""
    jobs: Jobs               # every field with a leading (T,) axis
    s: torch.Tensor          # (T,) f32
    P: torch.Tensor          # (T,) i32
    seed: torch.Tensor       # (T,) i64 holding the JAX module's u32
    n_valid: int


def table_from_stacked(jobs: Jobs, s_vals, P_vals, seeds) -> TrialTable:
    """TrialTable from an already-stacked Jobs batch (the ``run_sweep``
    calling convention). Scalars broadcast over T."""
    T = int(jobs.submit.shape[0])
    if T == 0:
        raise ValueError("empty trial table")

    def vec(x, dtype):
        a = np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor)
                       else x).astype(dtype)
        if a.ndim == 0:
            a = np.full((T,), a, dtype)
        if a.shape != (T,):
            raise ValueError(f"per-trial vector has shape {a.shape}; "
                             f"expected ({T},)")
        return a

    seed = vec(seeds, np.uint32).astype(np.int64)
    return TrialTable(jobs=jobs, s=torch.from_numpy(vec(s_vals, np.float32)),
                      P=torch.from_numpy(vec(P_vals, np.int32)),
                      seed=torch.from_numpy(seed), n_valid=T)


def build_table(jobsets: Sequence[JobSet], s_vals, P_vals,
                seeds) -> TrialTable:
    """TrialTable from one jobset per trial (``stack_jobsets`` pads
    ragged job counts with sentinel JOBS; :func:`pad_table` pads the
    trial axis with sentinel TRIALS: the same ``valid=False`` contract
    on another axis)."""
    if len(jobsets) == 0:
        raise ValueError("empty trial table")
    return table_from_stacked(stack_jobsets(jobsets), s_vals, P_vals,
                              seeds)


def pad_table(table: TrialTable, multiple: int) -> TrialTable:
    """Pad the trial axis to a multiple of ``multiple`` with sentinel
    trials (all-sentinel jobs: born DONE, all-nan summaries), the JAX
    module's padding to a device count. :func:`run_table` drops the
    padded rows of a table it pads itself; :func:`pooled_tables` never
    sees an invalid job."""
    T = int(table.s.shape[0])
    pad = -T % multiple
    if pad == 0:
        return table

    def ext(x, fill):
        return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype)])

    return TrialTable(jobs=_extend(table.jobs, pad), s=ext(table.s, 0.0),
                      P=ext(table.P, 0), seed=ext(table.seed, 0),
                      n_valid=table.n_valid)


# ----------------------------------------------------- per-trial stats

def _masked_pct(vals, mask, ps) -> torch.Tensor:
    """(T, len(ps)) percentiles of each trial's ``vals[mask]``, with
    the port's float32 rule (``sim_torch.masked_percentile_rows``);
    ``nan`` for a trial whose mask selects nothing, which then drops
    out of every nan-aware pooled table."""
    return sim_torch.masked_percentile_rows(vals, mask, ps)


def _masked_frac(mask, hit) -> torch.Tensor:
    """(T,) fraction of each trial's ``mask`` rows with ``hit`` set, in
    float32; ``nan`` for an empty class."""
    n = mask.sum(-1).to(F32)
    frac = (mask & hit).sum(-1).to(F32) / n
    return torch.where(n > 0, frac, float("nan"))


def _trial_percentiles(jobs: Jobs, st: sim_batch.State) -> Dict:
    """The classic ``run_sweep`` per-trial summary dict (kept key for
    key: callers index these names)."""
    sd = sim_torch.slowdown(jobs, st)
    te = jobs.is_te & jobs.valid
    be = ~jobs.is_te & jobs.valid
    iv = (st.last_resume - st.last_signal).to(F32)
    iv_mask = (st.last_resume >= 0) & jobs.valid
    pc = st.preempt_count
    return {
        "te_slowdown": _masked_pct(sd, te, (50, 95, 99)),
        "be_slowdown": _masked_pct(sd, be, (50, 95, 99)),
        "intervals": _masked_pct(iv, iv_mask, (50, 75, 95, 99)),
        "preempted_frac": _masked_frac(be, pc > 0),
        "preempt_1": _masked_frac(be, pc == 1),
        "preempt_2": _masked_frac(be, pc == 2),
        "preempt_3plus": _masked_frac(be, pc >= 3),
        "makespan": st.t,
    }


def _trial_per_job(jobs: Jobs, st: sim_batch.State) -> Dict:
    """Raw per-job arrays, for host-side pooling ACROSS trials
    (:func:`pooled_tables`: percentiles over the pooled per-job values,
    the paper's 8-workload pooling). Sentinel jobs carry nan slowdown,
    nan interval and zero preempt_count; ``intervals`` is the LAST
    signal-to-resume gap per job, as in the JAX module."""
    sd = sim_torch.slowdown(jobs, st)
    iv = (st.last_resume - st.last_signal).to(F32)
    iv_mask = (st.last_resume >= 0) & jobs.valid
    return {
        "slowdown": torch.where(jobs.valid, sd, float("nan")),
        "preempt_count": torch.where(jobs.valid, st.preempt_count, 0),
        "intervals": torch.where(iv_mask, iv, float("nan")),
        "valid": jobs.valid,
        "is_te": jobs.is_te,
        "makespan": st.t,
        "fallback_count": st.fallback_count,
    }


_TRIAL_FNS = {"percentiles": _trial_percentiles, "per_job": _trial_per_job}


# ------------------------------------------------------------ results

@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Host-side result of one fabric run: ``stats`` maps summary name
    to an ndarray with leading trial axis (sentinel-padding rows already
    dropped: every array has exactly ``n_trials`` rows). ``out`` records
    which per-trial summary produced it ("percentiles": the classic
    ``run_sweep`` dict; "per_job": raw per-job arrays for
    :func:`pooled_tables`). ``engine_stats`` holds the batched
    engine's counters of the run (``sim_batch.run``'s ``stats``)."""
    stats: Dict[str, np.ndarray]
    n_trials: int
    n_padded: int
    n_devices: int
    out: str
    time_mode: str
    engine_stats: Dict = dataclasses.field(default_factory=dict,
                                           compare=False)

    def __getitem__(self, k: str) -> np.ndarray:
        return self.stats[k]


def run_table(cfg: SimConfig, table: TrialTable, *,
              devices: Optional[int] = None,
              time_mode: Optional[str] = None,
              out: str = "percentiles",
              device=None) -> SweepResult:
    """Run every trial of ``table`` under the static ``cfg`` in one
    batched engine run on ``device`` (the current CUDA device unless
    given; ``"cpu"`` runs the plain path); the entry point everything
    batches through.

    ``devices`` is ``mesh_for_sweep``'s: the table runs on one device
    (the default); an explicit request for several that are present
    raises (multi-device sweeps are not ported). ``time_mode`` defaults to ``cfg.time_mode``;
    ``out`` selects the per-trial summary (:data:`_TRIAL_FNS`). The
    table is left as it was (no donation)."""
    if out not in _TRIAL_FNS:
        raise ValueError(f"unknown out {out!r}; one of "
                         f"{tuple(_TRIAL_FNS)}")
    dev = _device.resolve(device)
    if time_mode is None:
        time_mode = cfg.time_mode
    T = int(table.s.shape[0])
    mesh_for_sweep(T, devices=devices, device=dev)
    jobs = table.jobs.map(lambda x: x.to(dev))
    engine_stats: Dict = {}
    st = sim_batch.run(cfg, jobs, table.s.to(dev), table.P.to(dev),
                       table.seed.to(dev), time_mode=time_mode,
                       stats=engine_stats)
    raw = _TRIAL_FNS[out](jobs, st)
    stats = {k: v.cpu().numpy()[:T] for k, v in raw.items()}
    return SweepResult(stats=stats, n_trials=T, n_padded=0, n_devices=1,
                       out=out, time_mode=time_mode,
                       engine_stats=engine_stats)


def pooled_tables(result: SweepResult,
                  trials: Optional[Sequence[int]] = None) -> Dict:
    """Paper-style pooled tables from a ``per_job`` fabric run:
    percentiles over the POOLED per-job values across trials (the paper
    pools its 8 workloads per cell), mirroring ``metrics.pooled_tables``
    key for key. ``trials`` selects the trial rows forming one cell
    (default: all); sentinel jobs (and any sentinel-trial rows a caller
    kept) are masked through the ``valid`` column."""
    if result.out != "per_job":
        raise ValueError("pooled_tables needs a per_job SweepResult; "
                         f"got out={result.out!r}")
    idx = (np.arange(result.n_trials) if trials is None
           else np.asarray(trials, np.intp))
    valid = result.stats["valid"][idx]
    is_te = result.stats["is_te"][idx]
    sd = result.stats["slowdown"][idx]
    pc = result.stats["preempt_count"][idx]
    iv = result.stats["intervals"][idx]
    te, be = valid & is_te, valid & ~is_te
    pc_be = pc[be]
    n_be = len(pc_be) if len(pc_be) else float("nan")
    return {
        "TE": metrics.percentiles(sd[te]),
        "BE": metrics.percentiles(sd[be]),
        "intervals": metrics.percentiles(iv[~np.isnan(iv)],
                                         ps=(50, 75, 95, 99)),
        "preempted_frac": (float((pc_be > 0).mean()) if len(pc_be)
                           else float("nan")),
        "preempt_counts": {
            "1": float((pc_be == 1).sum()) / n_be,
            "2": float((pc_be == 2).sum()) / n_be,
            ">=3": float((pc_be >= 3).sum()) / n_be,
        },
    }

"""Named synthetic scenarios: the paper's §4.2 / §4.4 workloads and
the stress library beyond them (the port's copy of the JAX package's
``scenarios/library.py``, every array bit-identical for the same
config).

Every scenario is a ``SimConfig -> JobSet`` function registered under
``@register_scenario`` (see registry.py): it samples per-class
execution / demand / grace-period marginals from ``cfg.workload`` (the
paper's fitted truncated normals) and differs in the *arrival process*,
*class mix*, *gang structure* or *GP structure* — the axes the paper
could not explore on its single private trace.

Determinism: every scenario derives its rng from ``cfg.seed`` (plus a
per-scenario salt so two scenarios never share a stream) and scales
with ``cfg.workload.n_jobs``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.cluster import SimConfig, TruncNormal
from repro_torch.core import workload
from repro_torch.core.stream.source import JobSource, materialize
from repro_torch.core.types import JobSet
from repro_torch.scenarios.registry import SYNTHETIC, register_scenario

# ---------------------------------------------------------------------------
# shared sampling helpers
# ---------------------------------------------------------------------------


def _rng(cfg: SimConfig, salt: int) -> np.random.Generator:
    return np.random.default_rng((cfg.seed, salt))


def _class_samples(cfg: SimConfig, rng: np.random.Generator, n: int,
                   te_fraction: float = None, is_te: np.ndarray = None):
    """(is_te, exec_total, demand, gp) from the cfg per-class marginals.

    ``is_te`` overrides the Bernoulli class draw when the scenario
    assigns classes itself (e.g. burst membership)."""
    wl = cfg.workload
    if is_te is None:
        frac = wl.te_fraction if te_fraction is None else te_fraction
        is_te = rng.random(n) < frac
    exec_total = np.zeros(n, np.int64)
    demand = np.zeros((n, 3))
    n_te = int(is_te.sum())
    exec_total[is_te], demand[is_te] = workload.sample_class(
        rng, wl.te, n_te, wl.gpu_quanta)
    exec_total[~is_te], demand[~is_te] = workload.sample_class(
        rng, wl.be, n - n_te, wl.gpu_quanta)
    gp = np.round(workload.sample_trunc_normal(
        rng, wl.scaled_gp(), n)).astype(np.int64)
    return is_te, exec_total, demand, gp


def _rate(cfg: SimConfig, exec_total, demand, n_nodes=1,
          load: float = None) -> float:
    """Arrival rate [jobs/min] that injects ``load`` × cluster capacity
    of work per minute (open-loop analogue of the closed-loop target)."""
    cluster_cap = (np.asarray(cfg.cluster.node.as_tuple())
                   * cfg.cluster.n_nodes)
    work = exec_total * workload.cluster_fraction(demand, cluster_cap) \
        * n_nodes
    tgt = cfg.workload.load if load is None else load
    return tgt / max(float(np.mean(work)), 1e-9)


def _submit_from_gaps(gaps: np.ndarray) -> np.ndarray:
    return np.floor(np.cumsum(gaps)).astype(np.int64)


def _sorted_jobset(submit, exec_total, demand, is_te, gp,
                   n_nodes=None) -> JobSet:
    order = np.argsort(submit, kind="stable")
    return JobSet(
        submit=np.asarray(submit, np.int64)[order],
        exec_total=np.asarray(exec_total, np.int64)[order],
        demand=np.asarray(demand, np.float64)[order],
        is_te=np.asarray(is_te, bool)[order],
        gp=np.asarray(gp, np.int64)[order],
        n_nodes=None if n_nodes is None
        else np.asarray(n_nodes, np.int64)[order])


# ---------------------------------------------------------------------------
# the paper's own generators, re-registered
# ---------------------------------------------------------------------------

register_scenario(
    "paper-synthetic", kind=SYNTHETIC,
    description="Paper §4.2: truncated-normal classes, closed-loop "
                "admission at FIFO-normalized load",
    knobs={"workload.load": "FIFO-normalized backlog target (2.0)",
           "workload.te_fraction": "share of TE jobs (0.30)",
           "workload.multi_node_frac": "gang fraction (0 = paper)"},
)(workload.generate)

register_scenario(
    "trace-proxy", kind=SYNTHETIC,
    description="Paper §4.4 proxy: log-normal executions, bursty "
                "day/night arrivals",
    knobs={"workload.load": "target work injection rate",
           "workload.multi_node_frac": "gang fraction (0 = paper)"},
)(workload.generate_trace_proxy)


@register_scenario(
    "sparse-long-horizon", kind=SYNTHETIC,
    knobs={"workload.n_jobs": "job count",
           "gap_mean": "mean arrival gap, minutes (180)"})
def sparse_long_horizon(cfg: SimConfig, gap_mean: float = 180.0) -> JobSet:
    """Trickle arrivals over a long horizon (engine-benchmark regime)."""
    return workload.sparse_long_horizon(cfg.workload.n_jobs, seed=cfg.seed,
                                        gap_mean=gap_mean)


# ---------------------------------------------------------------------------
# stress scenarios (beyond the paper)
# ---------------------------------------------------------------------------


@register_scenario(
    "diurnal", kind=SYNTHETIC,
    knobs={"period_min": "day length, minutes (1440)",
           "amplitude": "rate swing, 0..1 (0.8)",
           "workload.load": "mean work injection rate"})
def diurnal(cfg: SimConfig, period_min: float = 1440.0,
            amplitude: float = 0.8) -> JobSet:
    """Sinusoidal day/night arrival intensity around the target load."""
    rng = _rng(cfg, 101)
    n = cfg.workload.n_jobs
    is_te, exec_total, demand, gp = _class_samples(cfg, rng, n)
    lam = _rate(cfg, exec_total, demand)
    gaps = rng.exponential(1.0 / lam, n)
    # modulate by the local time-of-day intensity (first-order: phase
    # from the unmodulated clock)
    t_approx = np.cumsum(gaps)
    intensity = 1.0 + amplitude * np.sin(2 * np.pi * t_approx / period_min)
    gaps = gaps / np.maximum(intensity, 1e-3)
    return _sorted_jobset(_submit_from_gaps(gaps), exec_total, demand,
                          is_te, gp)


@register_scenario(
    "burst-storm", kind=SYNTHETIC,
    knobs={"n_bursts": "number of TE storms (6)",
           "burst_frac": "share of jobs inside bursts (0.4)",
           "burst_width_min": "storm duration, minutes (5)"})
def burst_storm(cfg: SimConfig, n_bursts: int = 6, burst_frac: float = 0.4,
                burst_width_min: float = 5.0) -> JobSet:
    """Steady BE background + compact storms of TE arrivals.

    The worst case for victim selection: many TEs demand placement in
    the same handful of minutes, so a policy that preempts large or
    long-GP victims pays immediately."""
    rng = _rng(cfg, 102)
    n = cfg.workload.n_jobs
    # the background stream anchors the burst times, so keep >= 1 of it
    n_burst = min(int(n * burst_frac), n - 1)
    n_bg = n - n_burst

    is_te = np.zeros(n, bool)
    is_te[:n_bg] = rng.random(n_bg) < 0.1          # background: mostly BE
    is_te[n_bg:] = rng.random(n_burst) < 0.9       # storms: mostly TE
    _, exec_total, demand, gp = _class_samples(cfg, rng, n, is_te=is_te)

    lam = _rate(cfg, exec_total[:n_bg], demand[:n_bg])
    submit = np.zeros(n, np.int64)
    submit[:n_bg] = _submit_from_gaps(rng.exponential(1.0 / lam, n_bg))
    horizon = max(int(submit[:n_bg].max()), 1)
    starts = rng.uniform(0, horizon, n_bursts)
    which = rng.integers(0, n_bursts, n_burst)
    submit[n_bg:] = np.floor(
        starts[which] + rng.uniform(0, burst_width_min, n_burst)
    ).astype(np.int64)
    return _sorted_jobset(submit, exec_total, demand, is_te, gp)


@register_scenario(
    "gang-heavy", kind=SYNTHETIC,
    knobs={"gang_frac": "fraction of jobs that are gangs (0.5)",
           "widths": "gang widths sampled uniformly (2, 4, 8)"})
def gang_heavy(cfg: SimConfig, gang_frac: float = 0.5,
               widths=(2, 4, 8)) -> JobSet:
    """Distributed-DL regime: half the jobs are multi-node gangs.

    Reuses the paper generator (closed-loop admission) with the
    beyond-paper gang knobs turned up; stresses all-or-nothing
    placement and gang victim selection."""
    widths = tuple(w for w in widths if w <= cfg.cluster.n_nodes)
    wl = dataclasses.replace(cfg.workload, multi_node_frac=gang_frac,
                             multi_node_widths=widths or (2,))
    return workload.generate(dataclasses.replace(cfg, workload=wl))


@register_scenario(
    "gang-trace-mix", kind=SYNTHETIC,
    knobs={"gang_frac": "fraction of jobs that are gangs (0.35)",
           "widths": "empirical inst_num widths from the PAI fixture"})
def gang_trace_mix(cfg: SimConfig, gang_frac: float = 0.35) -> JobSet:
    """Synthetic arrivals with gang widths resampled from the PAI
    fixture's empirical ``inst_num`` distribution.

    The dedicated stress workload for gang-aware placement and victim
    selection: unlike ``gang-heavy``'s uniform widths, the width mix
    here is the one a real task table reports (mostly 1, a long-ish
    tail of 2/4/8-instance workers), over an open-loop arrival
    process — wide gangs must be packed around a churning single-node
    background."""
    from repro_torch.scenarios.traces import PAI_SAMPLE, load_pai_csv

    rng = _rng(cfg, 108)
    n = cfg.workload.n_jobs
    is_te, exec_total, demand, gp = _class_samples(cfg, rng, n)
    pai_widths = np.asarray(load_pai_csv(PAI_SAMPLE, cfg).n_nodes)
    pai_widths = pai_widths[pai_widths <= cfg.cluster.n_nodes]
    if len(pai_widths) == 0:
        pai_widths = np.ones(1, np.int64)
    gang = rng.random(n) < gang_frac
    n_nodes = np.where(gang, rng.choice(pai_widths, n), 1).astype(np.int64)
    lam = _rate(cfg, exec_total, demand, n_nodes=n_nodes)
    gaps = rng.exponential(1.0 / lam, n)
    return _sorted_jobset(_submit_from_gaps(gaps), exec_total, demand,
                          is_te, gp, n_nodes=n_nodes)


@register_scenario(
    "load-ramp", kind=SYNTHETIC,
    knobs={"ramp_lo": "initial load multiplier (0.25)",
           "ramp_hi": "final load multiplier (4.0)"})
def load_ramp(cfg: SimConfig, ramp_lo: float = 0.25,
              ramp_hi: float = 4.0) -> JobSet:
    """Arrival rate ramps linearly from under- to over-subscription.

    Crosses the load=1 boundary mid-trace: the early segment measures
    pure placement latency, the late segment queue-growth behaviour."""
    rng = _rng(cfg, 103)
    n = cfg.workload.n_jobs
    is_te, exec_total, demand, gp = _class_samples(cfg, rng, n)
    lam = _rate(cfg, exec_total, demand)
    ramp = np.linspace(ramp_lo, ramp_hi, n)
    gaps = rng.exponential(1.0 / lam, n) / ramp
    return _sorted_jobset(_submit_from_gaps(gaps), exec_total, demand,
                          is_te, gp)


@register_scenario(
    "te-flood", kind=SYNTHETIC,
    knobs={"te_fraction": "share of TE jobs (0.85)",
           "load_mult": "load multiplier vs cfg.workload.load (1.5)"})
def te_flood(cfg: SimConfig, te_fraction: float = 0.85,
             load_mult: float = 1.5) -> JobSet:
    """Inverted class mix: TE jobs dominate the arrival stream.

    With few BE victims to evict, preemptive policies degrade toward
    FIFO — the regime where the paper's 30%-TE assumption breaks."""
    rng = _rng(cfg, 104)
    n = cfg.workload.n_jobs
    is_te, exec_total, demand, gp = _class_samples(
        cfg, rng, n, te_fraction=te_fraction)
    lam = _rate(cfg, exec_total, demand,
                load=cfg.workload.load * load_mult)
    gaps = rng.exponential(1.0 / lam, n)
    return _sorted_jobset(_submit_from_gaps(gaps), exec_total, demand,
                          is_te, gp)


@register_scenario(
    "long-tail-be", kind=SYNTHETIC,
    knobs={"sigma": "BE log-normal shape (2.0)",
           "median_min": "BE median execution, minutes (30)",
           "cap_min": "BE execution cap, minutes (2880)"})
def long_tail_be(cfg: SimConfig, sigma: float = 2.0,
                 median_min: float = 30.0, cap_min: float = 2880.0
                 ) -> JobSet:
    """Heavy-tailed BE executions: a few multi-day jobs hold resources.

    Long-running victims maximize the cost of a bad preemption choice
    (LRTP's target) and of head-of-line blocking under FIFO."""
    rng = _rng(cfg, 105)
    n = cfg.workload.n_jobs
    is_te, exec_total, demand, gp = _class_samples(cfg, rng, n)
    be = ~is_te
    tail = np.exp(np.log(median_min)
                  + sigma * rng.standard_normal(int(be.sum())))
    exec_total[be] = np.maximum(
        np.clip(tail, 3.0, cap_min).astype(np.int64), 1)
    lam = _rate(cfg, exec_total, demand)
    gaps = rng.exponential(1.0 / lam, n)
    return _sorted_jobset(_submit_from_gaps(gaps), exec_total, demand,
                          is_te, gp)


@register_scenario(
    "maintenance-drain", kind=SYNTHETIC,
    knobs={"drain_start_frac": "window start as horizon fraction (0.4)",
           "drain_min": "window length, minutes (240)"})
def maintenance_drain(cfg: SimConfig, drain_start_frac: float = 0.4,
                      drain_min: float = 240.0) -> JobSet:
    """Submission freeze mid-trace, then the deferred backlog floods in.

    Models a maintenance window: arrivals inside [t0, t0+drain) are
    held and released together at the window end — an adversarial
    step-function in queue depth."""
    rng = _rng(cfg, 106)
    n = cfg.workload.n_jobs
    is_te, exec_total, demand, gp = _class_samples(cfg, rng, n)
    lam = _rate(cfg, exec_total, demand)
    submit = _submit_from_gaps(rng.exponential(1.0 / lam, n))
    t0 = int(submit.max() * drain_start_frac)
    t1 = t0 + int(drain_min)
    submit = np.where((submit >= t0) & (submit < t1), t1, submit)
    return _sorted_jobset(submit, exec_total, demand, is_te, gp)


@register_scenario(
    "heterogeneous-gp", kind=SYNTHETIC,
    knobs={"zero_gp_frac": "share of GP=0 (checkpoint-free) BE jobs (0.5)",
           "long_gp": "TruncNormal(12, 6, [5, 40]) for the rest"})
def heterogeneous_gp(cfg: SimConfig, zero_gp_frac: float = 0.5) -> JobSet:
    """Bimodal grace periods: instant-vacate jobs next to slow movers.

    Maximizes the spread FitGpp's GP term (Eq. 3) can exploit; under
    GP-blind policies the long-GP half dominates re-scheduling
    intervals."""
    rng = _rng(cfg, 107)
    n = cfg.workload.n_jobs
    is_te, exec_total, demand, gp = _class_samples(cfg, rng, n)
    zero = rng.random(n) < zero_gp_frac
    long_gp = np.round(workload.sample_trunc_normal(
        rng, TruncNormal(12.0, 6.0, 5.0, 40.0), n)).astype(np.int64)
    gp = np.where(zero, 0, long_gp)
    lam = _rate(cfg, exec_total, demand)
    gaps = rng.exponential(1.0 / lam, n)
    return _sorted_jobset(_submit_from_gaps(gaps), exec_total, demand,
                          is_te, gp)


def _stream_synthetic_source(cfg: SimConfig) -> JobSource:
    return JobSource(workload.stream_chunks(cfg))


@register_scenario(
    "stream-synthetic", kind=SYNTHETIC,
    source=_stream_synthetic_source,
    knobs={"n_jobs": "total jobs (workload.n_jobs; streams O(chunk))",
           "load": "open-loop arrival intensity (workload.load)",
           "chunk": "generator chunk size, jobs (1024)"})
def stream_synthetic(cfg: SimConfig) -> JobSet:
    """Open-loop chunked synthetic stream (workload.stream_chunks).

    The §4.4 trace-proxy arrival model in streamable form: chunk k is
    drawn entirely from ``rng((seed, k))``, so any window of the
    stream regenerates without its prefix and the stream engine replays
    10^5-10^6 jobs in O(capacity) memory. Unlike ``paper-synthetic``,
    arrivals are open-loop — sub-critical ``workload.load`` (< ~0.9)
    keeps the backlog bounded. This entry materializes the same stream
    for the monolithic engines."""
    return materialize(_stream_synthetic_source(cfg))


def _stream_closed_loop_source(cfg: SimConfig) -> JobSource:
    from repro_torch.core.stream.admission import ClosedLoopAdmission
    return JobSource(ClosedLoopAdmission(
        cfg, JobSource(workload.stream_chunks(cfg))))


@register_scenario(
    "stream-closed-loop", kind=SYNTHETIC,
    source=_stream_closed_loop_source,
    knobs={"n_jobs": "total jobs (workload.n_jobs; streams O(backlog))",
           "load": "FIFO-normalized backlog target (workload.load, "
                   "2.0 = the paper's saturated regime)",
           "chunk": "generator chunk size, jobs (1024)"})
def stream_closed_loop(cfg: SimConfig) -> JobSet:
    """The §4.2 closed-loop arrival regime in streamable form: the
    chunked synthetic job data of ``stream-synthetic`` with its
    open-loop submit times re-stamped as closed-loop admit ticks
    holding the FIFO-normalized backlog at ``workload.load``
    (``stream.ClosedLoopAdmission``); the closed loop itself bounds the
    backlog, so a saturated load (2.0) streams in O(backlog + chunk)
    memory. This entry computes the same admit ticks monolithically
    (``workload.closed_loop_submit_times``) for the monolithic engines;
    streamed and monolithic runs are equal
    (``stream.verify_closed_loop_parity``)."""
    js = materialize(JobSource(workload.stream_chunks(cfg)))
    js.submit = workload.closed_loop_submit_times(cfg, js)
    return js

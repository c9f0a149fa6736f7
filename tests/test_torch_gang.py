"""Gang jobs and bounded backfill on the port's engine, against the JAX
engine and the numpy reference.

The primitives (``_gang_fit``, ``_gang_fits``, ``_gang_select`` in both
forms and the backfill gate's scan) are held against ``sim_jax`` on
random seeded states. Whole runs: the gang scenarios at the JAX suite's
size (84 nodes, 96 jobs) for every deterministic policy in both time
modes, with and without backfill, and on contended clusters (3-24
nodes) where gangs preempt,
against ``repro.core.simulator.simulate``; a few runs field for field
against ``sim_jax.run_jit``; tick == event for every policy, RAND
included. The port draws its random numbers from a torch generator, so
the score policies' width-1 random fallback (a different stream in each
engine) must not fire where a run is compared across engines: those
cases assert it did not."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro.configs import cluster as jcluster
from repro.core import sim_jax, simulator
from repro.core.types import JobSet
from repro_torch import api as tapi
from repro_torch.configs import cluster as tcluster
from repro_torch.core import sim_torch

GANG_SCENARIOS = ("gang-heavy", "gang-trace-mix", "philly-sample",
                  "pai-sample")
EXACT = ["fifo", "fitgpp", "minsize", "lrtp", "srtp"]
ALL = EXACT + ["rand"]
SCORE = ("fitgpp", "minsize")
RANK = ("lrtp", "srtp")
COMPARED = [f for f in sim_jax.State._fields
            if f not in ("rng", "ev_buf", "ev_n")]
# the JAX suite's gang matrix: the paper's 84 nodes, 96 jobs
PAPER = dict(n_nodes=84, n_jobs=96, P=1, seed=0)
# contended: gangs wait, preempt and hit the P cap here
TIGHT = dict(n_nodes=16, n_jobs=192, P=4, seed=0)
# the trace fixtures hold 26-28 jobs: a cluster small enough to contend
TRACE_TIGHT = dict(n_nodes=3, n_jobs=96, P=2, seed=0)


def configs(policy, n_nodes, n_jobs, P, seed, backfill=False):
    kw = dict(policy=policy, seed=seed, max_preemptions=P,
              backfill=backfill)
    j = jcluster.SimConfig(cluster=jcluster.ClusterSpec(n_nodes=n_nodes),
                           workload=jcluster.WorkloadSpec(n_jobs=n_jobs),
                           **kw)
    t = tcluster.SimConfig(cluster=tcluster.ClusterSpec(n_nodes=n_nodes),
                           workload=tcluster.WorkloadSpec(n_jobs=n_jobs),
                           **kw)
    return j, t


@functools.lru_cache(maxsize=None)
def jobset(scenario, n_nodes, n_jobs, seed):
    jcfg, _ = configs("fifo", n_nodes, n_jobs, 1, seed)
    return jscenarios.build(scenario, jcfg)


@functools.lru_cache(maxsize=None)
def torch_run(scenario, policy, mode, n_nodes, n_jobs, P, seed,
              backfill=False):
    _, tcfg = configs(policy, n_nodes, n_jobs, P, seed, backfill)
    jobs = sim_torch.jobs_from_jobset(
        jobset(scenario, n_nodes, n_jobs, seed), "cpu")
    return sim_torch.state_to_numpy(sim_torch.run(tcfg, jobs, seed,
                                                  time_mode=mode))


def reference(scenario, policy, n_nodes, n_jobs, P, seed, backfill=False,
              mode="event"):
    jcfg, _ = configs(policy, n_nodes, n_jobs, P, seed, backfill)
    return simulator.simulate(jcfg, jobset(scenario, n_nodes, n_jobs, seed),
                              mode=mode)


def assert_matches_reference(got, ref, ctx):
    np.testing.assert_array_equal(got["finish"], ref.finish, err_msg=ctx)
    np.testing.assert_array_equal(got["preempt_count"], ref.preempt_count,
                                  err_msg=ctx)


def jax_numpy(st):
    return {f: np.asarray(getattr(st, f)) for f in COMPARED}


def assert_fields_equal(want, got, ctx=""):
    diff = [f for f in COMPARED if not np.array_equal(want[f], got[f])]
    assert not diff, f"{ctx}: fields differ: {diff}"


# ---------------------------------------------------------------------------
# primitives on random seeded states
# ---------------------------------------------------------------------------

def random_cluster(rng, N, M):
    """Integer demands and free vectors, multi-node assignments."""
    demand = np.stack([rng.integers(1, 17, N), rng.integers(1, 129, N),
                       rng.choice([0.0, 1.0, 2.0, 4.0], N)], 1)
    free = np.stack([rng.integers(0, 33, M), rng.integers(0, 257, M),
                     rng.integers(0, 9, M)], 1).astype(np.float32)
    width = rng.choice([1, 2, 3, 4], N)
    assign = np.zeros((N, M), bool)
    for j in range(N):
        assign[j, rng.choice(M, min(width[j], M), replace=False)] = True
    return demand.astype(np.float32), free, width.astype(np.int32), assign


@pytest.mark.parametrize("seed", range(6))
def test_gang_fit_and_fits_match_jax(seed):
    rng = np.random.default_rng(seed)
    demand, free, width, _ = random_cluster(rng, 40, 12)
    got = sim_torch._gang_fits(torch.from_numpy(free),
                               torch.from_numpy(demand),
                               torch.from_numpy(width))
    want = sim_jax._gang_fits(jnp.asarray(free), jnp.asarray(demand),
                              jnp.asarray(width))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for j in range(len(demand)):
        for w in (1, 2, int(width[j]), 5):
            ok, mask = sim_torch._gang_fit(torch.from_numpy(free),
                                           torch.from_numpy(demand[j]), w)
            jok, jmask = sim_jax._gang_fit(jnp.asarray(free),
                                           jnp.asarray(demand[j]), w)
            assert bool(ok) == bool(jok)
            np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def random_state(seed, N=48, M=10, P=2):
    """A JAX ``State`` with running BE gangs, queued jobs, preemption
    counts around the P cap and a queued gang TE (the last row) that
    fits no node; in every third state most running jobs are TEs (no
    candidates) and the cluster is full, so often no set of victims
    suffices."""
    rng = np.random.default_rng(seed)
    demand, free, width, assign = random_cluster(rng, N, M)
    is_te = rng.random(N) < (0.6 if seed % 3 == 2 else 0.25)
    te = N - 1
    is_te[te] = True
    width[te] = rng.integers(2, 7)
    demand[te] = [rng.integers(4, 17), rng.integers(16, 129),
                  rng.choice([2.0, 4.0, 8.0])]
    if seed % 3 == 2:
        free[:] = 0.0
        demand[te] = [16.0, 64.0, 8.0]
    # the TE fits no node now (it is blocked, as when the engine calls)
    blocked = (free >= demand[te] - 1e-9).all(1)
    free[blocked, 2] = demand[te, 2] - 1.0
    state = np.where(rng.random(N) < 0.7, sim_jax.RUNNING, sim_jax.QUEUED)
    state[te] = sim_jax.QUEUED
    assign &= (state == sim_jax.RUNNING)[:, None]
    js = JobSet(submit=np.zeros(N, np.int64),
                exec_total=rng.integers(1, 100, N),
                demand=demand.astype(np.float64), is_te=is_te,
                gp=rng.integers(0, 4, N), n_nodes=width.astype(np.int64))
    jobs = sim_jax.jobs_from_jobset(js)
    st = sim_jax.init_state(jobs, M, (32.0, 256.0, 8.0), seed)
    st = st._replace(
        state=jnp.asarray(state, jnp.int32),
        assign=jnp.asarray(assign),
        free=jnp.asarray(free),
        remaining=jnp.asarray(rng.integers(1, 100, N), jnp.int32),
        preempt_count=jnp.asarray(rng.integers(0, P + 2, N), jnp.int32),
        queue_key=jnp.asarray(np.where(state == sim_jax.QUEUED,
                                       rng.permutation(N), np.inf),
                              jnp.float32),
        t=jnp.asarray(7, jnp.int32))
    return js, jobs, st, te


_jax_gang_select = jax.jit(sim_jax._gang_select, static_argnames=("P",))


@pytest.mark.parametrize("form", ["score", "rank"])
def test_gang_select_matches_jax(form):
    """Both forms on 24 random states each: the victims signalled, in
    order, and the fallback count, as the JAX ``_gang_select`` leaves
    the State. The cases cover a sufficient single victim (score form),
    a sufficient accumulation, an insufficient one (nothing signalled)
    and over-cap signals."""
    P = 2
    seen = {"none": 0, "one": 0, "several": 0, "over_cap": 0}
    for seed in range(24):
        js, jobs, st, te = random_state(seed, P=P)
        tj = sim_torch.jobs_from_jobset(js, "cpu")
        rank = np.random.default_rng(seed + 100).permutation(
            len(js.submit)).astype(np.float32)
        score = jnp.asarray(-rank) if form == "score" else None
        want = _jax_gang_select(st, jobs, jnp.int32(te), jnp.asarray(rank),
                                P, score=score)
        tst = sim_torch.state_from_numpy(jax_numpy(st), 0, "cpu")
        picks = sim_torch._gang_select(
            tst, tj, te, int(js.n_nodes[te]), torch.from_numpy(rank), P,
            score=None if score is None else torch.from_numpy(-rank))
        for v, over_cap in picks:
            tst.fallback_count += int(over_cap)
            sim_torch._signal_one(tst, tj, v, te, int(js.gp[v]))
        assert_fields_equal(jax_numpy(want), sim_torch.state_to_numpy(tst),
                            f"{form} seed {seed}")
        seen[("none", "one")[len(picks)] if len(picks) < 2
             else "several"] += 1
        seen["over_cap"] += sum(o for _, o in picks)
    print(seen)
    assert all(seen.values()), seen


@pytest.mark.parametrize("form", ["score", "rank"])
def test_gang_select_akey_ties_match_jax(form):
    """Both forms with tied ranks (three values over all jobs) and a
    permuted ``akey``: the port picks, in order, the victims the JAX
    ``_gang_select`` signals (the smallest akey among tied ranks)."""
    P = 2
    differs = 0
    for seed in range(24):
        js, jobs, st, te = random_state(seed, P=P)
        rng = np.random.default_rng(seed + 200)
        akey = rng.permutation(len(js.submit)).astype(np.float32)
        rank = rng.integers(0, 3, len(js.submit)).astype(np.float32)
        score = jnp.asarray(-rank) if form == "score" else None
        want = _jax_gang_select(st, jobs._replace(akey=jnp.asarray(akey)),
                                jnp.int32(te), jnp.asarray(rank), P,
                                score=score)
        tj = dataclasses.replace(sim_torch.jobs_from_jobset(js, "cpu"),
                                 akey=torch.from_numpy(akey))
        tst = sim_torch.state_from_numpy(jax_numpy(st), 0, "cpu")
        args = (tst, tj, te, int(js.n_nodes[te]), torch.from_numpy(rank), P)
        tscore = None if score is None else torch.from_numpy(-rank)
        picks = sim_torch._gang_select(*args, score=tscore)
        differs += picks != sim_torch._gang_select(
            *args[:1], dataclasses.replace(tj, akey=None), *args[2:],
            score=tscore)
        for v, over_cap in picks:
            tst.fallback_count += int(over_cap)
            sim_torch._signal_one(tst, tj, v, te, int(js.gp[v]))
        assert_fields_equal(jax_numpy(want), sim_torch.state_to_numpy(tst),
                            f"{form} seed {seed}")
    assert differs > 0          # the ties changed some picks


def argsort_would_act(be_q, fits, key, depth):
    """The JAX engine's backfill scan, literally (``sim_jax``'s
    ``_make_would_act_cached``): the first ``depth`` jobs of an argsort
    of the masked keys."""
    order = np.argsort(np.where(be_q, key, np.inf), kind="stable")
    scan = order[:depth]
    return bool((be_q[scan] & fits[scan]).any())


@pytest.mark.parametrize("seed", range(4))
def test_backfill_gate_equals_argsort_scan(seed):
    """The gate's sort-free scan gives the argsort form's verdict with
    the depth below, equal to and above the queue length."""
    rng = np.random.default_rng(seed)
    N = 64
    key = rng.permutation(N).astype(np.float32) - 20.0   # unique keys
    for trial in range(40):
        be_q = rng.random(N) < rng.uniform(0.05, 0.6)
        fits = rng.random(N) < rng.uniform(0.0, 0.3)
        n_q = int(be_q.sum())
        for depth in {0, 1, max(n_q - 1, 0), n_q, n_q + 1, N}:
            want = argsort_would_act(be_q, fits, key, min(depth, N))
            got = sim_torch._backfill_would_act(
                torch.from_numpy(be_q), torch.from_numpy(fits),
                torch.from_numpy(key), min(depth, N))
            assert bool(got) == want, (seed, trial, depth, n_q)


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backfill", [False, True])
@pytest.mark.parametrize("mode", ["event", "tick"])
@pytest.mark.parametrize("policy", EXACT)
@pytest.mark.parametrize("scenario", GANG_SCENARIOS)
def test_gang_scenarios_match_reference(scenario, policy, mode, backfill):
    """The JAX suite's gang matrix (84 nodes, 96 jobs) on the port,
    with and without backfill."""
    got = torch_run(scenario, policy, mode, backfill=backfill, **PAPER)
    if policy in SCORE:
        assert got["fallback_count"] == 0
    assert_matches_reference(
        got, reference(scenario, policy, backfill=backfill, mode=mode,
                       **PAPER), f"{scenario}/{policy}/{mode}/{backfill}")


CONTENDED = [(s, p, bf) for s in ("gang-heavy", "gang-trace-mix")
             for p in RANK for bf in (False, True)] + [
    # score policies where no width-1 random fallback fires
    ("gang-trace-mix", "fitgpp", False), ("gang-trace-mix", "minsize",
                                          False),
    ("gang-heavy", "fitgpp", True)]


@pytest.mark.parametrize("scenario,policy,backfill", CONTENDED)
def test_contended_gangs_match_reference(scenario, policy, backfill):
    """Gangs that preempt, signal past the P cap and backfill."""
    size = dict(TIGHT, seed=2, n_nodes=24, n_jobs=256) \
        if (scenario, policy, backfill) == ("gang-heavy", "fitgpp", True) \
        else TIGHT
    got = torch_run(scenario, policy, "event", backfill=backfill, **size)
    ref = reference(scenario, policy, backfill=backfill, **size)
    assert got["preempt_count"].sum() > 0
    assert_matches_reference(got, ref, f"{scenario}/{policy}/{backfill}")


@pytest.mark.parametrize("scenario", ["philly-sample", "pai-sample"])
@pytest.mark.parametrize("policy", RANK)
def test_contended_traces_match_reference(scenario, policy):
    got = torch_run(scenario, policy, "event", **TRACE_TIGHT)
    assert got["preempt_count"].sum() > 0
    assert_matches_reference(got, reference(scenario, policy, **TRACE_TIGHT),
                             f"{scenario}/{policy}")


@pytest.mark.parametrize("scenario,policy,mode,backfill", [
    ("gang-trace-mix", "fitgpp", "event", False),
    ("gang-heavy", "lrtp", "tick", False),
    ("gang-heavy", "srtp", "event", True)])
def test_matches_jax_engine_field_for_field(scenario, policy, mode,
                                            backfill):
    """Full State against ``sim_jax.run_jit`` on a contended cluster
    (one JAX compile a case): score and rank policies, one backfill."""
    jcfg, _ = configs(policy, backfill=backfill, **TIGHT)
    js = jobset(scenario, TIGHT["n_nodes"], TIGHT["n_jobs"], TIGHT["seed"])
    jst = sim_jax.run_jit(jcfg, sim_jax.jobs_from_jobset(js), TIGHT["seed"],
                          time_mode=mode)
    got = torch_run(scenario, policy, mode, backfill=backfill, **TIGHT)
    assert got["preempt_count"].sum() > 0
    assert_fields_equal(jax_numpy(jst), got, f"{scenario}/{policy}/{mode}")


TICK_EVENT = [(s, size) for s, size in (
    ("gang-heavy", TIGHT), ("gang-trace-mix", TIGHT),
    ("philly-sample", TRACE_TIGHT), ("pai-sample", TRACE_TIGHT))]


@pytest.mark.parametrize("policy", ALL)
@pytest.mark.parametrize("scenario,size", TICK_EVENT,
                         ids=[s for s, _ in TICK_EVENT])
def test_tick_equals_event(scenario, size, policy):
    """Full State, generator included, on contended gang workloads:
    the event jump runs every tick that could act, so even the random
    draws (RAND's ranks, the width-1 fallback) agree."""
    a = torch_run(scenario, policy, "tick", **size)
    b = torch_run(scenario, policy, "event", **size)
    assert sim_torch.state_diff_fields(a, b) == []
    if policy != "fifo":
        assert a["preempt_count"].sum() > 0


def test_gang_backfill_both_axes():
    """``tests/test_engine_parity.py::test_gang_backfill_both_axes`` on
    the port: srtp with backfill on gang-heavy, tick == event field for
    field, and both equal to the reference."""
    a = torch_run("gang-heavy", "srtp", "tick", backfill=True, **PAPER)
    b = torch_run("gang-heavy", "srtp", "event", backfill=True, **PAPER)
    assert sim_torch.state_diff_fields(a, b) == []
    ref = reference("gang-heavy", "srtp", backfill=True, mode="tick",
                    **PAPER)
    assert_matches_reference(a, ref, "gang backfill")


def test_gang_te_placed_in_the_tick_its_gp0_victims_vacate():
    """A gang TE of width 2 on two full nodes: its two GP=0 victims
    vacate inline and the TE starts in the same tick, before the BE
    lane can take the nodes back."""
    js = JobSet(submit=np.array([0, 0, 0, 3]),
                exec_total=np.array([50, 50, 40, 5]),
                demand=np.array([[32.0, 200.0, 8.0], [32.0, 200.0, 8.0],
                                 [32.0, 200.0, 8.0], [16.0, 64.0, 4.0]]),
                is_te=np.array([False, False, False, True]),
                gp=np.array([0, 0, 0, 0]), n_nodes=np.array([1, 1, 1, 2]))
    for policy in ("fitgpp", "lrtp"):
        jcfg, tcfg = configs(policy, n_nodes=2, n_jobs=4, P=1, seed=0)
        st = sim_torch.run(tcfg, sim_torch.jobs_from_jobset(js, "cpu"), 0)
        ref = simulator.simulate(jcfg, js)
        np.testing.assert_array_equal(st.finish.numpy(), ref.finish)
        np.testing.assert_array_equal(st.preempt_count.numpy(),
                                      ref.preempt_count)
        assert int(st.finish[3]) == 3 + 5          # started at its submit
        assert int(st.preempt_count.sum()) == 2


@pytest.mark.parametrize("scenario,policy,mode", [
    ("gang-trace-mix", "fitgpp", "event"), ("gang-heavy", "srtp", "tick")])
def test_gang_single_step_parity(scenario, policy, mode):
    """Carry every JAX ``make_tick`` State of a contended gang run
    (multi-node ``assign`` masks, gangs in grace) across, step both
    engines once from it, and compare the next States. (fitgpp on
    gang-trace-mix: its width-1 random fallback never fires there.)"""
    jcfg, tcfg = configs(policy, **TIGHT)
    n = TIGHT["n_nodes"]
    js = jobset(scenario, n, TIGHT["n_jobs"], TIGHT["seed"])
    jj = sim_jax.jobs_from_jobset(js)
    tj = sim_torch.jobs_from_jobset(js, "cpu")
    jtick = jax.jit(sim_jax.make_tick(jcfg, jj, n, time_mode=mode))
    ttick = sim_torch.make_tick(tcfg, tj, n, time_mode=mode)
    st = sim_jax.init_state(jj, n, (32.0, 256.0, 8.0), TIGHT["seed"])
    steps, multi = 0, 0
    while int(st.n_done) < js.n and steps < 400:
        nxt = jtick(st)
        d = jax_numpy(st)
        multi += int((d["assign"].sum(1) > 1).any())
        got = ttick(sim_torch.state_from_numpy(d, TIGHT["seed"], "cpu"))
        assert_fields_equal(jax_numpy(nxt), sim_torch.state_to_numpy(got),
                            f"{policy}/{mode} step {steps}")
        st, steps = nxt, steps + 1
    assert multi > 0 and int(np.asarray(st.preempt_count).sum()) > 0


def test_api_backfill_knob():
    """``run_experiment(backfill=True)`` runs the backfill engine."""
    r = tapi.run_experiment("gang-heavy", "srtp", n_jobs=96, seed=0,
                            backfill=True, device="cpu")
    assert r.cfg.backfill and tapi.make_config(backfill=True).backfill
    np.testing.assert_array_equal(
        r.raw.state.finish.numpy(),
        torch_run("gang-heavy", "srtp", "event", backfill=True,
                  **PAPER)["finish"])

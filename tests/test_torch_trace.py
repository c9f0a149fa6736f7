"""The torch engine's event ring on the CPU against the JAX engine's
(``sim_jax.run_jit(..., trace=True)``): with the same capacity,
``ev_buf`` and ``ev_n`` equal bit for bit on the cases of
``tests/test_trace_parity.py`` (the paper's 84 nodes with gangs and both
trace adapters; a 16-node cluster where preemption and backfill emit the
whole vocabulary), in both time modes. Also the ring's own mechanics:
tick == event with the ring in the State, single steps == the run, the
overflow count and intact prefix of an undersized ring, an untraced run
that carries no ring and schedules exactly as a traced one, and the
slowdown decomposition identity on the torch engine's traces.

The port draws its random numbers from a torch generator, so a score
policy's random fallback is a different stream in each engine: every
case compared across engines asserts that it did not fire."""
import functools

import numpy as np
import pytest

from repro import scenarios as jscenarios
from repro.configs import cluster as jcluster
from repro.core import sim_jax
from repro_torch.configs import cluster as tcluster
from repro_torch.core import metrics, sim_torch
from repro_torch.kernels import ops
from repro_torch.obs import schema, timeseries
from torch_threads import one_thread  # noqa: F401

SCORE = ("fitgpp", "minsize")
# (scenario, policy, mode) at the paper's 84 nodes, 96 jobs
PAPER_CASES = [(s, p, "event") for s in ("gang-heavy", "philly-sample",
                                         "pai-sample")
               for p in ("fitgpp", "lrtp")] + [("gang-heavy", "fitgpp",
                                                "tick")]
VOCABULARY = {schema.PREEMPT_SIGNAL, schema.GRACE_EXPIRE, schema.VACATE,
              schema.REQUEUE, schema.RESUME, schema.BACKFILL}


def configs(policy, n_nodes=84, n_jobs=96, seed=0, **kw):
    kw = dict(policy=policy, seed=seed, **kw)
    j = jcluster.SimConfig(cluster=jcluster.ClusterSpec(n_nodes=n_nodes),
                           workload=jcluster.WorkloadSpec(n_jobs=n_jobs),
                           **kw)
    t = tcluster.SimConfig(cluster=tcluster.ClusterSpec(n_nodes=n_nodes),
                           workload=tcluster.WorkloadSpec(n_jobs=n_jobs),
                           **kw)
    return j, t


@functools.lru_cache(maxsize=None)
def jobset(scenario, n_nodes=84, n_jobs=96, seed=0):
    jcfg, _ = configs("fifo", n_nodes, n_jobs, seed)
    return jscenarios.build(scenario, jcfg)


def torch_run(tcfg, js, mode="event", trace=True, trace_capacity=None):
    return sim_torch.run(tcfg, sim_torch.jobs_from_jobset(js, "cpu"),
                         tcfg.seed, time_mode=mode, trace=trace,
                         trace_capacity=trace_capacity)


def assert_ring_matches_jax(scenario, policy, mode, trace_capacity=None,
                            **kw):
    """Both engines traced on one JobSet: the same ring, bit for bit,
    and the same non-ring result; returns the decoded stream."""
    jcfg, tcfg = configs(policy, **kw)
    js = jobset(scenario, jcfg.cluster.n_nodes, jcfg.workload.n_jobs,
                jcfg.seed)
    jst = sim_jax.run_jit(jcfg, sim_jax.jobs_from_jobset(js), jcfg.seed,
                          time_mode=mode, trace=True,
                          trace_capacity=trace_capacity)
    tst = torch_run(tcfg, js, mode, trace_capacity=trace_capacity)
    if policy in SCORE:
        assert int(jst.fallback_count) == tst.fallback_count == 0, \
            "random fallback fired; pick a quieter config"
    want = np.asarray(jst.ev_buf)
    got = tst.ev_buf.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert tst.ev_n == int(jst.ev_n)
    bad = np.flatnonzero((got != want).any(1))
    assert not len(bad), f"rings differ from row {bad[0]}: " \
        f"{got[bad[0]].tolist()} vs {want[bad[0]].tolist()}"
    np.testing.assert_array_equal(tst.finish.numpy(), np.asarray(jst.finish))
    np.testing.assert_array_equal(tst.preempt_count.numpy(),
                                  np.asarray(jst.preempt_count))
    assert sim_torch.trace_overflow(tst) == int(sim_jax.trace_overflow(jst))
    events, overflow = sim_torch.decode_trace(tst)
    if overflow == 0:
        schema.validate_events(events, n_jobs=js.n,
                               n_nodes=jcfg.cluster.n_nodes)
    return events


@pytest.mark.parametrize("scenario,policy,mode", PAPER_CASES)
def test_ring_matches_jax_paper_cluster(scenario, policy, mode):
    events = assert_ring_matches_jax(scenario, policy, mode)
    assert {e.code for e in events} >= {schema.SUBMIT, schema.START,
                                        schema.FINISH}


@pytest.mark.parametrize("mode", ["tick", "event"])
def test_ring_matches_jax_preemption_heavy(mode):
    events = assert_ring_matches_jax("gang-heavy", "lrtp", mode,
                                     n_nodes=16, seed=3)
    assert VOCABULARY - {schema.BACKFILL} <= {e.code for e in events}


@pytest.mark.parametrize("mode", ["tick", "event"])
def test_ring_matches_jax_backfill_markers(mode):
    events = assert_ring_matches_jax("gang-heavy", "lrtp", mode,
                                     n_nodes=16, seed=3, backfill=True)
    assert VOCABULARY <= {e.code for e in events}
    skips = [e.aux for e in events if e.code == schema.BACKFILL]
    assert skips and all(s > 0 for s in skips)
    # a GP=0 victim vacates inline: SIGNAL, VACATE, REQUEUE in a row
    assert any(a.code == schema.PREEMPT_SIGNAL and b.code == schema.VACATE
               and (a.t, a.job, a.aux) == (b.t, b.job, b.aux)
               for a, b in zip(events, events[1:]))


def test_ring_overflow_matches_jax():
    """An undersized ring (32 rows): the same buffer and ``ev_n`` as
    JAX, the overflow counted, and the kept prefix equal to the first
    32 events of the untruncated stream."""
    full = assert_ring_matches_jax("gang-heavy", "lrtp", "event",
                                   n_nodes=16, seed=3)
    _, tcfg = configs("lrtp", n_nodes=16, seed=3)
    st = torch_run(tcfg, jobset("gang-heavy", 16, 96, 3),
                   trace_capacity=32)
    got, lost = sim_torch.decode_trace(st)
    assert lost == sim_torch.trace_overflow(st) == len(full) - 32 > 0
    assert st.ev_n == len(full)
    assert not st.ev_buf[32].any()                   # the dump row
    metrics.assert_trace_parity(full[:32], got)
    assert_ring_matches_jax("gang-heavy", "lrtp", "event",
                            trace_capacity=32, n_nodes=16, seed=3)


TRACED_CONFIGS = [("gang-heavy", "lrtp", 16, 3, False),
                  ("gang-heavy", "lrtp", 16, 3, True),
                  ("te-flood", "fitgpp", 8, 3, False)]


@pytest.mark.parametrize("scenario,policy,n_nodes,seed,backfill",
                         TRACED_CONFIGS)
def test_tick_equals_event_with_ring(scenario, policy, n_nodes, seed,
                                     backfill):
    """The whole traced State, ring included, is bit-identical across
    time modes: the drain jump emits the FINISH rows the skipped ticks
    would have, in their order."""
    _, tcfg = configs(policy, n_nodes=n_nodes, seed=seed, backfill=backfill)
    js = jobset(scenario, n_nodes, 96, seed)
    a = sim_torch.state_to_numpy(torch_run(tcfg, js, "tick"))
    b = sim_torch.state_to_numpy(torch_run(tcfg, js, "event"))
    assert a["ev_n"] > 0 and a["ev_buf"].shape[0] > a["ev_n"]
    assert not sim_torch.state_diff_fields(a, b)


@pytest.mark.parametrize("mode", ["tick", "event"])
def test_single_steps_equal_traced_run(mode):
    """``make_tick(trace=True)`` stepped from ``init_state`` with a ring
    reaches the traced run's final State, ring included."""
    _, tcfg = configs("lrtp", n_nodes=16, seed=3)
    js = jobset("gang-heavy", 16, 96, 3)
    jobs = sim_torch.jobs_from_jobset(js, "cpu")
    cap = sim_torch.resolve_trace_capacity(tcfg, jobs)
    st = sim_torch.init_state(jobs, 16, tcfg.cluster.node.as_tuple(), 3,
                              trace_capacity=cap)
    step = sim_torch.make_tick(tcfg, jobs, 16, time_mode=mode, trace=True)
    while st.n_done < js.n:
        step(st)
    want = sim_torch.state_to_numpy(torch_run(tcfg, js, mode))
    assert not sim_torch.state_diff_fields(sim_torch.state_to_numpy(st),
                                           want)
    untraced = sim_torch.init_state(jobs, 16, tcfg.cluster.node.as_tuple(),
                                    3)
    with pytest.raises(ValueError, match="ring"):
        step(untraced)


def test_capacity_matches_jax_and_default_fits():
    jcfg, tcfg = configs("lrtp", n_nodes=16, seed=3, max_preemptions=3)
    js = jobset("gang-heavy", 16, 96, 3)
    jjobs = sim_jax.jobs_from_jobset(js)
    tjobs = sim_torch.jobs_from_jobset(js, "cpu")
    for cap in (None, 7, 1000):
        assert sim_torch.resolve_trace_capacity(tcfg, tjobs, cap) == \
            sim_jax.resolve_trace_capacity(jcfg, jjobs, cap)
    st = torch_run(tcfg, js)
    assert st.ev_buf.shape == (sim_torch.resolve_trace_capacity(
        tcfg, tjobs) + 1, 5)
    assert sim_torch.trace_overflow(st) == 0
    assert sim_torch.result_summary(tjobs, st)["trace_overflow"] == 0
    with pytest.raises(ValueError, match="trace_capacity"):
        torch_run(tcfg, js, trace_capacity=0)


@pytest.mark.parametrize("scenario,policy,n_nodes,seed,backfill",
                         TRACED_CONFIGS)
def test_untraced_run_has_no_ring_and_same_schedule(
        monkeypatch, scenario, policy, n_nodes, seed, backfill):
    """``trace=False`` carries a zero-size ring and reports no
    overflow; every other field equals the traced run's, and both run
    the same number of schedule passes (and kernel launches)."""
    calls = {"n": 0}
    plain = ops.schedule_step

    def counted(*a, **k):
        calls["n"] += 1
        return plain(*a, **k)

    monkeypatch.setattr(ops, "schedule_step", counted)
    _, tcfg = configs(policy, n_nodes=n_nodes, seed=seed, backfill=backfill)
    js = jobset(scenario, n_nodes, 96, seed)
    passes, launches, states = [], [], []
    for trace in (False, True):
        calls["n"] = 0
        launches0 = ops.LAUNCHES["schedule_step"]
        st = torch_run(tcfg, js, trace=trace)
        passes.append(calls["n"])
        launches.append(ops.LAUNCHES["schedule_step"] - launches0)
        states.append(sim_torch.state_to_numpy(st))
    untraced, traced = states
    assert untraced["ev_buf"].shape == (0, 0) and untraced["ev_n"] == 0
    assert traced["ev_n"] > 0
    assert passes[0] == passes[1] > 0 and launches[0] == launches[1]
    diff = sim_torch.state_diff_fields(untraced, traced)
    assert set(diff) == {"ev_buf", "ev_n"}
    tjobs = sim_torch.jobs_from_jobset(js, "cpu")
    st = torch_run(tcfg, js, trace=False)
    assert sim_torch.trace_overflow(st) == 0
    assert sim_torch.decode_trace(st) == ([], 0)
    assert sim_torch.result_summary(tjobs, st)["trace_overflow"] == 0


def test_state_from_numpy_builds_untraced_state():
    _, tcfg = configs("lrtp", n_nodes=16, seed=3)
    st = torch_run(tcfg, jobset("gang-heavy", 16, 96, 3))
    arrays = sim_torch.state_to_numpy(st)
    back = sim_torch.state_from_numpy(arrays, 3, "cpu")
    assert back.ev_buf.shape == (0, 0) and back.ev_n == 0
    diff = sim_torch.state_diff_fields(arrays,
                                       sim_torch.state_to_numpy(back))
    # the generator is reseeded from ``seed``; lrtp never draws
    assert set(diff) == {"ev_buf", "ev_n"}


@pytest.mark.parametrize("scenario,policy,n_nodes,seed,backfill",
                         TRACED_CONFIGS)
def test_decomposition_identity_every_job(scenario, policy, n_nodes, seed,
                                          backfill):
    """finish - submit == initial_wait + grace_stall + requeue_wait +
    service for every job of the torch engine's trace, with ``service``
    the job's execution time and ``finish`` the State's (the configs of
    ``tests/test_sim_jax_properties.py``)."""
    _, tcfg = configs(policy, n_nodes=n_nodes, seed=seed, backfill=backfill)
    js = jobset(scenario, n_nodes, 96, seed)
    st = torch_run(tcfg, js)
    events, overflow = sim_torch.decode_trace(st)
    assert overflow == 0
    schema.validate_events(events, n_jobs=js.n, n_nodes=n_nodes)
    dec = timeseries.slowdown_decomposition(events)
    assert set(dec) == set(range(js.n))
    finish = st.finish.numpy()
    n_preempted = 0
    for j, d in dec.items():
        assert d.finish == finish[j], (j, d)
        assert d.identity_holds(), (j, d)
        assert d.service == int(js.exec_total[j]), (j, d)
        n_preempted += d.grace_stall > 0 or d.requeue_wait > 0
    assert n_preempted > 0, "config exercised no preemption terms"

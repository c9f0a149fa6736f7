"""The port's numpy reference engine against the JAX package's, bit for
bit: ``repro_torch.core.simulator.simulate`` against
``repro.core.simulator.simulate`` through the port's own
``assert_result_parity`` (finish ticks, preemption counts, makespan, the
``PreemptionEvent`` stream and the event trace) on all 18 registered
scenarios under every policy, RAND included (both draw from
``np.random.default_rng(seed + 104729)``), in both time modes, and with
backfill on gang-heavy; its pieces (queue lanes, victim marshalling,
closed-loop admission) on seeded inputs; the facade's
``engine="reference"``; and the in-port check: the torch engine's ring,
decoded, equals the port's reference trace on the JAX package's
cross-engine matrix."""
import functools
import heapq

import numpy as np
import pytest
import torch

from repro import api as japi
from repro import scenarios as jscenarios
from repro.configs import cluster as jcluster
from repro.core import policy_registry as jregistry
from repro.core import simulator as jsimulator
from repro.core.engine import preemption as jpre
from repro.core.engine import queues as jqueues
from repro.core.policy_registry import RNG_ALWAYS
from repro_torch import api as tapi
from repro_torch.configs import cluster as tcluster
from repro_torch.core import (metrics, policy_registry, sim_torch, simulator,
                              workload as tworkload)
from repro_torch.core.engine import preemption as tpre
from repro_torch.core.engine import queues as tqueues
from repro_torch.obs import schema

NAMES = jscenarios.scenario_names()
POLICIES = policy_registry.policy_names()
# the JAX package's cross-engine trace matrix (tests/test_trace_parity.py)
JAX_EXACT = [s.name for s in jregistry.all_policies()
             if s.dual_backend and s.rng != RNG_ALWAYS]
TRACE_SCENARIOS = ("gang-heavy", "philly-sample", "pai-sample")


def configs(policy, n_nodes, n_jobs=96, seed=3, P=2, **kw):
    kw = dict(policy=policy, seed=seed, max_preemptions=P, **kw)
    j = jcluster.SimConfig(cluster=jcluster.ClusterSpec(n_nodes=n_nodes),
                           workload=jcluster.WorkloadSpec(n_jobs=n_jobs),
                           **kw)
    t = tcluster.SimConfig(cluster=tcluster.ClusterSpec(n_nodes=n_nodes),
                           workload=tcluster.WorkloadSpec(n_jobs=n_jobs),
                           **kw)
    return j, t


def contended_nodes(scenario):
    """A cluster small enough that most scenarios preempt; the trace
    fixtures' gangs need no more than 3 nodes."""
    return 3 if scenario.startswith(("philly", "pai")) else 8


@functools.lru_cache(maxsize=None)
def jobset(scenario, n_nodes, n_jobs=96, seed=3):
    jcfg, _ = configs("fifo", n_nodes, n_jobs, seed)
    return jscenarios.build(scenario, jcfg)


def assert_reference_parity(scenario, policy, mode, n_nodes, **kw):
    jcfg, tcfg = configs(policy, n_nodes, **kw)
    js = jobset(scenario, n_nodes, jcfg.workload.n_jobs, jcfg.seed)
    want = jsimulator.simulate(jcfg, js, mode=mode, trace=True)
    got = simulator.simulate(tcfg, js, mode=mode, trace=True)
    assert got.trace is not None and len(got.trace) >= 3 * js.n
    assert all(type(e) is schema.Event for e in got.trace)
    metrics.assert_result_parity(got, want)
    # nan-aware, exact: an empty class or no resume gives nan on both
    np.testing.assert_equal(metrics.slowdown_table(got),
                            metrics.slowdown_table(want))
    np.testing.assert_equal(metrics.resched_table(got),
                            metrics.resched_table(want))
    assert got.preempt_count_fractions() == want.preempt_count_fractions()
    return got


@pytest.mark.parametrize("mode", ["tick", "event"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("scenario", NAMES)
def test_reference_matches_jax_package(scenario, policy, mode):
    assert_reference_parity(scenario, policy, mode,
                            contended_nodes(scenario))


@pytest.mark.parametrize("mode", ["tick", "event"])
@pytest.mark.parametrize("policy", POLICIES)
def test_reference_matches_jax_package_backfill(policy, mode):
    got = assert_reference_parity("gang-heavy", policy, mode, 8,
                                  backfill=True)
    assert any(e.code == schema.BACKFILL for e in got.trace)


def test_matrix_preempts_and_covers_registry():
    assert POLICIES == jregistry.policy_names()
    assert len(NAMES) == 18
    preempting = sum(
        len(assert_reference_parity(s, "lrtp", "event",
                                    contended_nodes(s)).events) > 0
        for s in NAMES)
    assert preempting >= 12


class _CountingRng:
    """A numpy generator that counts ``integers`` draws: the score
    rules' random fallback is their only ``integers`` draw."""

    def __init__(self, rng):
        self.rng, self.n = rng, 0

    def integers(self, *a, **k):
        self.n += 1
        return self.rng.integers(*a, **k)

    def __getattr__(self, name):
        return getattr(self.rng, name)


@pytest.mark.parametrize("policy", ["fitgpp", "minsize"])
def test_reference_counts_score_fallbacks(policy):
    """The port's reference counts a score rule's random fallbacks: as
    many as the JAX package's reference draws them, on a run where
    they fire."""
    jcfg, tcfg = configs(policy, 8, P=1)
    js = jobset("te-flood", 8)
    want = jsimulator.Simulator(jcfg, js)
    want.core.rng = counting = _CountingRng(want.rng)
    got = tapi.run_experiment("te-flood", policy, "reference", cfg=tcfg,
                              jobs=js)
    metrics.assert_result_parity(got.raw, want.run())
    assert got.fallback_count == counting.n > 0


def test_untraced_reference_has_no_trace():
    jcfg, tcfg = configs("fitgpp", 8)
    js = jobset("te-flood", 8)
    got = simulator.simulate(tcfg, js)
    assert got.trace is None
    metrics.assert_result_parity(got, jsimulator.simulate(jcfg, js))


@pytest.mark.parametrize("scenario", ["paper-synthetic", "gang-heavy"])
def test_closed_loop_admission_matches_jax_package(scenario):
    """``Simulator(admission_target=...)`` admits the same jobs at the
    same ticks, and ``closed_loop_submit_times`` returns its admit
    times."""
    jcfg, tcfg = configs("fifo", 8, n_jobs=160)
    js = jobset(scenario, 8, 160)
    want = jsimulator.Simulator(jcfg, js, admission_target=2.0)
    want.run()
    got = simulator.Simulator(tcfg, js, admission_target=2.0)
    res = got.run()
    np.testing.assert_array_equal(got.admit_time, want.admit_time)
    np.testing.assert_array_equal(
        tworkload.closed_loop_submit_times(tcfg, js), got.admit_time)
    assert res.makespan > 0 and (res.finish > 0).all()


@pytest.mark.parametrize("scenario", ["paper-synthetic", "gang-heavy"])
def test_backfill_config_builds_jax_jobset(scenario):
    """A config with backfill admits its closed-loop jobs under FIFO
    with backfill, as the JAX package does, so the scenario's JobSet
    (and a facade run that builds it) equals the JAX package's."""
    from repro_torch import scenarios as tscenarios
    jcfg, tcfg = configs("fitgpp", 8, backfill=True)
    want = jscenarios.build(scenario, jcfg)
    got = tscenarios.build(scenario, tcfg)
    for f in ("submit", "exec_total", "demand", "is_te", "gp", "n_nodes"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    plain = jscenarios.build(scenario, configs("fitgpp", 8)[0])
    assert not np.array_equal(plain.submit, want.submit)


def test_queue_lanes_match_jax_package():
    """Random pushes, top requeues, reinserts, peeks and pops against
    the JAX package's lanes."""
    rng = np.random.default_rng(0)
    queued = {}
    a = jqueues.QueueLanes(lambda j: queued.get(j, False))
    b = tqueues.QueueLanes(lambda j: queued.get(j, False))
    popped = []
    for step in range(600):
        op = rng.integers(5)
        te = bool(rng.integers(2))
        if op == 0:
            j = int(rng.integers(200))
            queued[j] = True
            assert a.push_back(j, te) == b.push_back(j, te)
        elif op == 1:
            j = int(rng.integers(200))
            queued[j] = True
            assert a.requeue_top(j, te) == b.requeue_top(j, te)
        elif op == 2:
            j = a.pop(te)
            assert b.pop(te) == j
            if j >= 0:
                popped.append((j, te))
        elif op == 3 and popped:
            j, lane = popped.pop(int(rng.integers(len(popped))))
            if queued.get(j):
                a.reinsert(j, lane)
                b.reinsert(j, lane)
        else:
            j = int(rng.integers(200))
            queued[j] = not queued.get(j, False)
        assert a.peek(te) == b.peek(te)
        assert sorted(a.valid_jobs(te)) == sorted(b.valid_jobs(te))
        assert a.key == b.key and a.top_key == b.top_key
    assert heapq.nsmallest(5, a.be_heap) == heapq.nsmallest(5, b.be_heap)


@pytest.mark.parametrize("policy", POLICIES)
def test_victim_marshalling_matches_jax_package(policy):
    """``best_victim_node``, ``ranked_order`` and ``gang_select`` on
    seeded clusters, each side with its own generator of one seed."""
    rng = np.random.default_rng(1)
    node_cap = np.array([32.0, 256.0, 8.0])
    jpol = jregistry.make(policy, s=2.0)
    tpol = policy_registry.make(policy, s=2.0)
    assert (tpol.preemptive, tpol.argmin_select, tpol.s) == \
        (jpol.preemptive, jpol.argmin_select, jpol.s)
    if not tpol.preemptive:
        assert tpol.select() == jpol.select() == []
        return
    for trial in range(12):
        M, C = 6, int(rng.integers(1, 9))
        free = rng.integers(0, 9, (M, 3)) * np.array([4.0, 32.0, 1.0])
        nodes = [np.sort(rng.choice(M, int(rng.integers(1, 3)),
                                    replace=False)) for _ in range(C)]
        demand = rng.integers(1, 9, (C, 3)) * np.array([2.0, 16.0, 1.0])
        width = np.array([len(n) for n in nodes])
        gp = rng.integers(0, 10, C).astype(float)
        rem = rng.integers(1, 50, C).astype(float)
        under = rng.random(C) < 0.7
        te_d = rng.integers(1, 9, 3) * np.array([4.0, 32.0, 1.0])
        ids = np.sort(rng.choice(100, C, replace=False))
        for n, d in zip(nodes, demand):
            assert tpre.best_victim_node(n, free, d, te_d) == \
                jpre.best_victim_node(n, free, d, te_d)
        seed = int(rng.integers(1 << 30))
        np.testing.assert_array_equal(
            tpre.ranked_order(tpol, np.random.default_rng(seed), demand, gp,
                              rem, under, node_cap),
            jpre.ranked_order(jpol, np.random.default_rng(seed), demand, gp,
                              rem, under, node_cap))
        kw = dict(te_demand=te_d, width=int(rng.integers(1, 4)), free=free,
                  cand_ids=ids, cand_nodes=nodes, cand_demand=demand,
                  cand_width=width, cand_gp=gp, cand_remaining=rem,
                  under_cap=under, node_cap=node_cap)
        assert tpre.gang_select(policy=tpol, rng=np.random.default_rng(seed),
                                **kw) == \
            jpre.gang_select(policy=jpol, rng=np.random.default_rng(seed),
                             **kw)
        cand_node = np.array([tpre.best_victim_node(n, free, d, te_d)
                              for n, d in zip(nodes, demand)])
        sel = dict(te_demand=te_d, cand_ids=ids, cand_demand=demand,
                   cand_node_free=free[cand_node], cand_gp=gp,
                   cand_remaining=rem, under_cap=under,
                   all_run_demand=demand, all_run_gp=gp, node_cap=node_cap,
                   free_by_node=free, cand_node=cand_node)
        assert tpol.select(rng=np.random.default_rng(seed), **sel) == \
            jpol.select(rng=np.random.default_rng(seed), **sel)


@pytest.mark.parametrize("scenario,policy,backfill",
                         [("gang-heavy", "lrtp", False),
                          ("gang-heavy", "fitgpp", True),
                          ("te-flood", "rand", False)])
def test_facade_reference_engine_matches_jax_facade(scenario, policy,
                                                    backfill):
    kw = dict(n_jobs=96, n_nodes=8, seed=3, P=2, backfill=backfill,
              trace=True)
    want = japi.run_experiment(scenario, policy, "reference", **kw)
    got = tapi.run_experiment(scenario, policy, "reference", **kw)
    assert got.engine == "reference" and got.policy == policy
    np.testing.assert_equal(got.table, want.table)
    np.testing.assert_equal(got.intervals, want.intervals)
    np.testing.assert_equal(got.preempted_frac, want.preempted_frac)
    assert got.makespan == want.makespan
    assert got.trace_overflow == 0
    metrics.assert_trace_parity(got.events, want.events)
    metrics.assert_result_parity(got.raw, want.raw)


def test_facade_engine_rules(monkeypatch):
    """The reference engine never asks for a GPU and refuses a device
    and a ring capacity; an unknown engine still raises; the torch engine still needs a GPU
    or ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tapi.ENGINES == ("torch", "reference")
    r = tapi.run_experiment(engine="reference", n_jobs=16, n_nodes=2)
    assert r.events is None and r.makespan > 0
    rs = tapi.compare_policies(["fifo", "fitgpp"], engine="reference",
                               n_jobs=16, n_nodes=2)
    assert set(rs) == {"fifo", "fitgpp"}
    with pytest.raises(ValueError, match="host only"):
        tapi.run_experiment(engine="reference", device="cpu", n_jobs=16)
    with pytest.raises(ValueError, match="without a ring"):
        tapi.run_experiment(engine="reference", trace=True,
                            trace_capacity=64, n_jobs=16)
    with pytest.raises(ValueError, match="unknown engine"):
        tapi.run_experiment(engine="jax", n_jobs=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.run_experiment(engine="torch", n_jobs=16, n_nodes=2)


@pytest.mark.parametrize("mode", ["tick", "event"])
@pytest.mark.parametrize("policy", JAX_EXACT)
@pytest.mark.parametrize("scenario", TRACE_SCENARIOS)
def test_torch_trace_equals_port_reference(scenario, policy, mode):
    """The in-port check: the torch engine's decoded ring equals the
    port's reference trace, event for event (the JAX package's
    cross-engine matrix: 84 nodes, 96 jobs)."""
    _, tcfg = configs(policy, 84, seed=0, P=1)
    js = jobset(scenario, 84, 96, 0)
    r = tapi.run_experiment(scenario, policy, "torch", cfg=tcfg, jobs=js,
                            mode=mode, trace=True, device="cpu")
    if policy_registry.get_policy(policy).kind == "score":
        assert r.fallback_count == 0, "random fallback fired"
    ref = simulator.simulate(tcfg, js, mode=mode, trace=True)
    assert r.trace_overflow == 0
    metrics.assert_trace_parity(ref.trace, r.events)
    np.testing.assert_array_equal(r.raw.state.finish.numpy(), ref.finish)


@pytest.mark.parametrize("backfill", [False, True])
def test_torch_trace_equals_port_reference_contended(backfill):
    """The same on a contended 16-node cluster, where the trace holds
    every event kind."""
    _, tcfg = configs("lrtp", 16, seed=3, P=1, backfill=backfill)
    js = jobset("gang-heavy", 16, 96, 3)
    st = sim_torch.run(tcfg, sim_torch.jobs_from_jobset(js, "cpu"), 3,
                       trace=True)
    ref = simulator.simulate(tcfg, js, trace=True)
    events, overflow = sim_torch.decode_trace(st)
    assert overflow == 0
    metrics.assert_trace_parity(ref.trace, events)
    assert {e.code for e in events} >= {schema.PREEMPT_SIGNAL,
                                        schema.GRACE_EXPIRE, schema.RESUME}

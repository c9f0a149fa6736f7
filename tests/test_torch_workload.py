"""The port's host layers against the JAX package's: workload
generation (closed-loop admission included) bit for bit, configs and
their validation, the policy table, metrics and scenarios."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import cluster as jcluster
from repro.core import metrics as jmetrics
from repro.core import policy_registry as jregistry
from repro.core import simulator as jsimulator
from repro.core import workload as jworkload
from repro_torch.configs import base as tbase
from repro_torch.configs import cluster as tcluster
from repro_torch.core import metrics as tmetrics
from repro_torch.core import policies as tpolicies
from repro_torch.core import policy_registry as tregistry
from repro_torch.core import simulator as tsimulator
from repro_torch.core import workload as tworkload
from repro_torch import scenarios as tscenarios

JOBSET_FIELDS = ("submit", "exec_total", "demand", "is_te", "gp", "n_nodes")


def both_configs(**kw):
    n_jobs = kw.pop("n_jobs")
    n_nodes = kw.pop("n_nodes")
    j = jcluster.SimConfig(workload=jcluster.WorkloadSpec(n_jobs=n_jobs),
                           cluster=jcluster.ClusterSpec(n_nodes=n_nodes),
                           **kw)
    t = tcluster.SimConfig(workload=tcluster.WorkloadSpec(n_jobs=n_jobs),
                           cluster=tcluster.ClusterSpec(n_nodes=n_nodes),
                           **kw)
    return j, t


@pytest.mark.parametrize("n_jobs,n_nodes,seed", [
    (256, 8, 0), (256, 8, 1), (300, 8, 7), (512, 84, 2), (512, 84, 3),
    (128, 84, 11)])
def test_generate_bit_identical(n_jobs, n_nodes, seed):
    jcfg, tcfg = both_configs(n_jobs=n_jobs, n_nodes=n_nodes, seed=seed)
    a, b = jworkload.generate(jcfg), tworkload.generate(tcfg)
    for f in JOBSET_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_generate_seed_argument_overrides_config():
    jcfg, tcfg = both_configs(n_jobs=96, n_nodes=8, seed=0)
    np.testing.assert_array_equal(jworkload.generate(jcfg, seed=5).submit,
                                  tworkload.generate(tcfg, seed=5).submit)


@pytest.mark.parametrize("load", [0.5, 2.0, 3.5])
def test_closed_loop_submit_times_bit_identical(load):
    jcfg, tcfg = both_configs(n_jobs=200, n_nodes=8, seed=4)
    js = jworkload.generate(jcfg)
    jcfg = dataclasses.replace(jcfg, workload=dataclasses.replace(
        jcfg.workload, load=load))
    tcfg = dataclasses.replace(tcfg, workload=dataclasses.replace(
        tcfg.workload, load=load))
    np.testing.assert_array_equal(
        jworkload.closed_loop_submit_times(jcfg, js),
        tworkload.closed_loop_submit_times(tcfg, js))


def test_samplers_bit_identical():
    d = jcluster.WorkloadSpec().be
    for sampler in ("sample_trunc_normal",):
        a = getattr(jworkload, sampler)(np.random.default_rng(3), d.ram, 500)
        b = getattr(tworkload, sampler)(np.random.default_rng(3), d.ram, 500)
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(1).normal(3, 3, 64)
    np.testing.assert_array_equal(jworkload.snap(x, (0, 1, 2, 4, 8)),
                                  tworkload.snap(x, (0, 1, 2, 4, 8)))
    ja = jworkload.sample_class(np.random.default_rng(9), d, 77)
    tb = tworkload.sample_class(np.random.default_rng(9), d, 77)
    for x, y in zip(ja, tb):
        np.testing.assert_array_equal(x, y)


def test_admission_fraction_and_gate():
    js = jworkload.generate(jcluster.SimConfig(
        workload=jcluster.WorkloadSpec(n_jobs=64), seed=1))
    cap = np.array([32.0, 256.0, 8.0])
    a = jsimulator.admission_fraction(js.demand, js.n_nodes, cap, 84)
    b = tsimulator.admission_fraction(js.demand, js.n_nodes, cap, 84)
    np.testing.assert_array_equal(a, b)
    ga, gb = jsimulator.AdmissionGate(2.0), tsimulator.AdmissionGate(2.0)
    for f in a:
        ga.admit(f)
        gb.admit(f)
        assert ga.load == gb.load and ga.wants_next() == gb.wants_next()


def test_config_defaults_match():
    j = dataclasses.asdict(jcluster.SimConfig())
    t = dataclasses.asdict(tcluster.SimConfig())
    assert j.pop("score_backend") == "jnp"
    assert j == t
    assert (tbase.PAPER_S, tbase.PAPER_P) == (4.0, 1)


@pytest.mark.parametrize("kw,exc", [
    (dict(max_preemptions=-1), ValueError),
    (dict(s=float("nan")), ValueError),
    (dict(policy="nope"), ValueError),
    (dict(s=-1.0), ValueError),
    (dict(max_preemptions=1.5), ValueError),
    (dict(time_mode="fast"), ValueError)])
def test_config_validation(kw, exc):
    with pytest.raises(exc):
        tcluster.SimConfig(**kw)
    # gangs and backfill are valid configs
    assert tcluster.SimConfig(backfill=True, workload=tcluster.WorkloadSpec(
        multi_node_frac=0.2)).backfill


def test_policy_table_covers_jax_registry():
    """Every policy the JAX engine runs has an entry with the same
    preemptiveness and engine contract."""
    for spec in jregistry.all_policies():
        if not spec.dual_backend:
            continue
        t = tregistry.get_policy(spec.name)
        assert t.preemptive == spec.preemptive, spec.name
        assert t.kind == spec.jax_kind, spec.name
    assert tregistry.policy_names() == sorted(
        s.name for s in jregistry.all_policies() if s.dual_backend)


def test_score_policies_match_jax_declarations():
    """fitgpp's Eq. 3 and minsize's Eq. 1 scores equal ``jax_score``."""
    import jax.numpy as jnp
    from repro.core import sim_jax
    from repro_torch.core import sim_torch
    js = jworkload.generate(jcluster.SimConfig(
        workload=jcluster.WorkloadSpec(n_jobs=128), seed=2))
    jj = sim_jax.jobs_from_jobset(js)
    tj = sim_torch.jobs_from_jobset(js, "cpu")
    cand = np.random.default_rng(0).random(128) < 0.5
    cap = (32.0, 256.0, 8.0)
    for name, fn in (("fitgpp", tpolicies.fitgpp_score),
                     ("minsize", tpolicies.minsize_score)):
        want = jregistry.make(name).jax_score(jj, jnp.asarray(cand),
                                              jnp.asarray(cap), 4.0)
        got = fn(tj, torch.as_tensor(cand), torch.tensor(cap), 4.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_metrics_match_reference():
    rng = np.random.default_rng(0)
    sd = rng.random(300) * 5 + 1
    te = rng.random(300) < 0.3
    pool = {"slowdown": sd, "is_te": te,
            "preempt_count": rng.integers(0, 4, 300),
            "intervals": rng.random(40) * 10}
    assert tmetrics.pooled_tables(pool) == jmetrics.pooled_tables(pool)
    assert tmetrics.percentiles(sd) == jmetrics.percentiles(sd)
    assert tmetrics.percentiles(sd[:0]).keys() == {"p50", "p95", "p99"}

    class _Res:
        slowdown = sd
        is_te = te

    assert tmetrics.slowdown_table(_Res) == jmetrics.slowdown_table(_Res)


def test_scenarios_build_paper_synthetic_only():
    """paper-synthetic builds; an unknown name raises, listing the
    registered ones (every name of the JAX registry,
    ``tests/test_torch_scenarios.py``)."""
    tcfg = tcluster.SimConfig(workload=tcluster.WorkloadSpec(n_jobs=64))
    js = tscenarios.build("paper-synthetic", tcfg)
    assert js.n == 64
    assert "paper-synthetic" in tscenarios.scenario_names()
    with pytest.raises(KeyError, match="paper-synthetic"):
        tscenarios.build("no-such-scenario", tcfg)

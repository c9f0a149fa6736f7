"""The port's scenario registry, trace adapters, job sources and
workload generators against the JAX package's, array for array; and
every registered scenario run end to end through the port's facade."""
import dataclasses
import filecmp
import os

import numpy as np
import pytest

from repro import scenarios as jscenarios
from repro.configs import cluster as jcluster
from repro.core import workload as jworkload
from repro.core.stream import source as jsource
from repro_torch import api as tapi
from repro_torch import scenarios as tscenarios
from repro_torch.configs import cluster as tcluster
from repro_torch.core import workload as tworkload
from repro_torch.core.stream import source as tsource

JOBSET_FIELDS = ("submit", "exec_total", "demand", "is_te", "gp", "n_nodes")
NAMES = jscenarios.scenario_names()


def both_configs(n_jobs=96, n_nodes=84, seed=3, **wl):
    j = jcluster.SimConfig(
        workload=jcluster.WorkloadSpec(n_jobs=n_jobs, **wl),
        cluster=jcluster.ClusterSpec(n_nodes=n_nodes), seed=seed)
    t = tcluster.SimConfig(
        workload=tcluster.WorkloadSpec(n_jobs=n_jobs, **wl),
        cluster=tcluster.ClusterSpec(n_nodes=n_nodes), seed=seed)
    return j, t


def assert_jobsets_equal(a, b, ctx=""):
    assert a.n == b.n, ctx
    for f in JOBSET_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f"{ctx}: {f}"
        np.testing.assert_array_equal(x, y, err_msg=f"{ctx}: {f}")


def test_registry_matches_jax():
    """The same 18 names, kinds, knobs and descriptions."""
    assert tscenarios.scenario_names() == NAMES
    assert len(NAMES) == 18
    for kind in (jscenarios.SYNTHETIC, jscenarios.TRACE):
        assert tscenarios.scenario_names(kind) == \
            jscenarios.scenario_names(kind)
    for j, t in zip(jscenarios.all_scenarios(), tscenarios.all_scenarios()):
        assert (t.name, t.kind, t.knobs, t.description) == \
            (j.name, j.kind, j.knobs, j.description)
    assert tapi.scenario_names() == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_build_matches_jax(name):
    jcfg, tcfg = both_configs()
    assert_jobsets_equal(jscenarios.build(name, jcfg),
                         tscenarios.build(name, tcfg), name)


@pytest.mark.parametrize("name", ["gang-heavy", "gang-trace-mix",
                                  "philly-tiled", "trace-proxy"])
def test_build_matches_jax_on_a_small_cluster(name):
    """Gang widths are cut to the cluster (gang-heavy, gang-trace-mix,
    the trace adapters drop wider jobs), and load follows its size."""
    jcfg, tcfg = both_configs(n_jobs=200, n_nodes=3, seed=5)
    assert_jobsets_equal(jscenarios.build(name, jcfg),
                         tscenarios.build(name, tcfg), name)


@pytest.mark.parametrize("name", NAMES)
def test_run_experiment_runs_every_scenario(name):
    r = tapi.run_experiment(name, "fitgpp", n_jobs=64, n_nodes=12, seed=1,
                            device="cpu")
    js = tscenarios.build(name, r.cfg)
    assert r.raw.state.n_done == js.n
    assert (r.raw.state.finish.numpy() >= js.submit + js.exec_total).all()


def test_fixtures_byte_identical():
    jdir = os.path.dirname(jscenarios.traces.PHILLY_SAMPLE)
    tdir = os.path.dirname(tscenarios.traces.PHILLY_SAMPLE)
    assert jdir != tdir
    for name in ("philly_sample.csv", "pai_sample.csv"):
        assert filecmp.cmp(os.path.join(jdir, name),
                           os.path.join(tdir, name), shallow=False)


@pytest.mark.parametrize("dialect", ["philly", "pai"])
def test_trace_adapters_match_jax(dialect, tmp_path):
    """Loaders (drop accounting included), the streaming reader and the
    tiler on the bundled fixture and on a copy with malformed,
    zero-runtime and too-wide rows."""
    jt, tt = jscenarios.traces, tscenarios.traces
    path = {"philly": tt.PHILLY_SAMPLE, "pai": tt.PAI_SAMPLE}[dialect]
    bad = tmp_path / "bad.csv"
    rows = open(path).read().splitlines()
    extra = {"philly": ["x,vc1,not-a-time,2017-10-03 05:01:00,"
                        "2017-10-03 05:09:30,1,Pass",
                        "y,vc1,2017-10-03 09:00:00,2017-10-03 09:00:00,"
                        "2017-10-03 09:00:00,1,Pass",
                        "z,vc1,2017-10-03 09:10:00,2017-10-03 09:11:00,"
                        "2017-10-03 09:30:00,800,Pass"],
             "pai": ["x,tf,1,Terminated,nan?,1588000480,600,29,100",
                     "y,tf,1,Terminated,1588090000,1588090000,600,29,100",
                     "z,tf,90,Terminated,1588090100,1588090900,600,29,100"]}
    bad.write_text("\n".join(rows + extra[dialect]) + "\n")
    jload = getattr(jt, f"load_{dialect}_csv")
    tload = getattr(tt, f"load_{dialect}_csv")
    jcfg, tcfg = both_configs(n_jobs=100, seed=4)
    for p in (path, str(bad)):
        for kw in ({}, dict(te_runtime_min=10.0, time_scale=4.0)):
            ja, jstats = jload(p, jcfg, return_stats=True, **kw)
            ta, tstats = tload(p, tcfg, return_stats=True, **kw)
            assert_jobsets_equal(ja, ta, f"{p} {kw}")
            assert dataclasses.asdict(jstats) == dataclasses.asdict(tstats)
        jstats, tstats = jt.TraceStats(), tt.TraceStats()
        for a, b in zip(jt.iter_trace_csv(p, jcfg, dialect, chunk=7,
                                          stats=jstats),
                        tt.iter_trace_csv(p, tcfg, dialect, chunk=7,
                                          stats=tstats), strict=True):
            assert_jobsets_equal(a, b, f"{p} stream")
        assert dataclasses.asdict(jstats) == dataclasses.asdict(tstats)
    for a, b in zip(jt.tiled_trace_chunks(path, jcfg, dialect, repeats=3),
                    tt.tiled_trace_chunks(path, tcfg, dialect, repeats=3),
                    strict=True):
        assert_jobsets_equal(a, b, "tiled")
    assert_jobsets_equal(
        jsource.materialize(jt.tiled_source(path, jcfg, dialect)),
        tsource.materialize(tt.tiled_source(path, tcfg, dialect)), "tiled")


def test_gang_and_stream_generators_match_jax():
    """The generators with gang widths on, the trace proxy, the stream
    rate and chunks, and the sparse trickle workload."""
    jcfg, tcfg = both_configs(n_jobs=300, n_nodes=16, seed=7,
                              multi_node_frac=0.4,
                              multi_node_widths=(2, 3, 8))
    a, b = jworkload.generate(jcfg), tworkload.generate(tcfg)
    assert (b.n_nodes > 1).any()
    assert_jobsets_equal(a, b, "generate")
    assert_jobsets_equal(jworkload.generate_trace_proxy(jcfg),
                         tworkload.generate_trace_proxy(tcfg), "proxy")
    assert jworkload.stream_rate(jcfg) == tworkload.stream_rate(tcfg)
    for x, y in zip(jworkload.stream_chunks(jcfg, chunk=64),
                    tworkload.stream_chunks(tcfg, chunk=64), strict=True):
        assert_jobsets_equal(x, y, "stream_chunks")
    assert_jobsets_equal(jworkload.sparse_long_horizon(77, seed=2),
                         tworkload.sparse_long_horizon(77, seed=2), "sparse")
    wl = jcfg.workload
    np.testing.assert_array_equal(
        jworkload.sample_gang_widths(np.random.default_rng(1), wl, 500),
        tworkload.sample_gang_widths(np.random.default_rng(1), tcfg.workload,
                                     500))
    # no gangs: the rng stream is untouched, so paper-synthetic is too
    rng = np.random.default_rng(1)
    tworkload.sample_gang_widths(rng, tcluster.WorkloadSpec(), 500)
    assert rng.random() == np.random.default_rng(1).random()
    cap = np.array([32.0, 256.0, 8.0]) * 16
    np.testing.assert_array_equal(jworkload.cluster_fraction(a.demand, cap),
                                  tworkload.cluster_fraction(a.demand, cap))


def test_job_source_matches_jax():
    """take / take_due / peek_submit over uneven chunks, scan and
    materialize, from_jobset, and the ordering contract."""
    jcfg, tcfg = both_configs(n_jobs=500, seed=2)
    js = jworkload.generate(jcfg)
    for mod in (jsource, tsource):
        assert_jobsets_equal(mod.materialize(mod.from_jobset(js, chunk=37)),
                             js, mod.__name__)
    # a slow stream (4 nodes): take_due(t) stops inside it
    scfg = [dataclasses.replace(c, cluster=dataclasses.replace(
        c.cluster, n_nodes=4)) for c in (jcfg, tcfg)]
    jsrc = jsource.JobSource(jworkload.stream_chunks(scfg[0], chunk=50))
    tsrc = tsource.JobSource(tworkload.stream_chunks(scfg[1], chunk=50))
    for k in (1, 13, 64, 5):
        assert jsrc.peek_submit() == tsrc.peek_submit()
        assert_jobsets_equal(jsrc.take(k), tsrc.take(k), f"take {k}")
        t = jsrc.peek_submit() + 40
        assert_jobsets_equal(jsrc.take_due(t), tsrc.take_due(t), "take_due")
        assert jsrc.n_taken == tsrc.n_taken
    assert not tsrc.exhausted
    assert tsrc.take_due(-1) is None
    js_scan = jsource.scan(jsource.from_jobset(js, chunk=64), chunk=100)
    ts_scan = tsource.scan(tsource.from_jobset(js, chunk=64), chunk=100)
    assert dataclasses.asdict(js_scan) == dataclasses.asdict(ts_scan)
    assert (js_scan.n_be, js_scan.horizon) == (ts_scan.n_be, ts_scan.horizon)
    chunks = list(tworkload.stream_chunks(tcfg, chunk=100))
    with pytest.raises(ValueError, match="decrease"):
        tsource.materialize(tsource.JobSource(chunks[::-1]))
    with pytest.raises(ValueError, match="empty"):
        tsource.materialize(tsource.JobSource([]))


def test_get_source_waits_for_the_stream_engine():
    tcfg = tcluster.SimConfig(workload=tcluster.WorkloadSpec(n_jobs=64))
    with pytest.raises(NotImplementedError, match="stream engine"):
        tscenarios.get_source("philly-tiled", tcfg)
    with pytest.raises(KeyError, match="registered"):
        tscenarios.get_source("no-such-scenario", tcfg)

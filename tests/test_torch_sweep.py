"""The port's batched trial engine and sweep fabric against the JAX
sweep fabric and the port's own engines, on the CPU.

The grid is the JAX suite's (``tests/test_sweep_fabric.py::_table``):
burst-storm, 8 nodes, 64 jobs, 3 seeds, s = 4, P = 1. The port draws
its random fallback candidates and RAND's ranks from a counter-based
hash (``sim_batch.uniforms``), the JAX engine from its PRNG key, so the
two agree bit for bit where no draw decides: every trial whose JAX
``fallback_count`` is 0 is compared (tolerance 0: the per-job
slowdowns are float32 on both sides), and the number compared must be
> 0. A port lane with ``lane_drawn == 0`` took every decision as the
JAX lane did, so those are compared too. Each case compiles the JAX
engine's vmapped loop (about 4 s a summary on this kind of CPU): one
case per matrix runs unmarked, the rest are marked ``slow``."""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro.configs import cluster as jcluster
from repro.core import sweep as jsweep
from repro.core import sweep_fabric as jfabric
from repro_torch import api as tapi
from repro_torch import scenarios as tscenarios
from repro_torch.configs import cluster as tcluster
from repro_torch.core import metrics as tmetrics
from repro_torch.core import sim_batch, sim_torch
from repro_torch.core import simulator as tsimulator
from repro_torch.core import sweep as tsweep
from repro_torch.core import sweep_fabric as tfabric
from repro_torch.core.types import DONE
from repro_torch.kernels import ops as tops
from repro_torch.launch import mesh as tmesh
from repro_torch.sharding import trials as tsharding
from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*shard_map.*:DeprecationWarning")

EXACT = ["fifo", "fitgpp", "lrtp", "srtp", "minsize"]
ALL = EXACT + ["rand"]
MODES = ["event", "tick"]
RAGGED = ("te-flood", "burst-storm", "gang-heavy")


def _slow_but_first(cases):
    """Every case but the first marked ``slow`` (each compiles the JAX
    engine)."""
    return [pytest.param(*c, marks=() if i == 0 else pytest.mark.slow)
            for i, c in enumerate(cases)]


def configs(policy="fitgpp", n_jobs=64, nodes=8, **kw):
    j = jcluster.SimConfig(cluster=jcluster.ClusterSpec(n_nodes=nodes),
                           workload=jcluster.WorkloadSpec(n_jobs=n_jobs),
                           policy=policy, **kw)
    t = tcluster.SimConfig(cluster=tcluster.ClusterSpec(n_nodes=nodes),
                           workload=tcluster.WorkloadSpec(n_jobs=n_jobs),
                           policy=policy, **kw)
    return j, t


@functools.lru_cache(maxsize=None)
def jobsets(names=("burst-storm",), n_seeds=3, n_jobs=64, nodes=8,
            backfill=False):
    """(JAX JobSets, port JobSets), one per (name, seed), built by each
    package's own registry (closed-loop admission keeps the backfill
    switch) and checked equal array for array."""
    jcfg, tcfg = configs(n_jobs=n_jobs, nodes=nodes, backfill=backfill)
    jj = [jscenarios.build(n, dataclasses.replace(jcfg, seed=k))
          for n in names for k in range(n_seeds)]
    tj = [tscenarios.build(n, dataclasses.replace(tcfg, seed=k))
          for n in names for k in range(n_seeds)]
    for a, b in zip(jj, tj):
        for f in ("submit", "exec_total", "demand", "is_te", "gp",
                  "n_nodes"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    return jj, tj


def tables(names=("burst-storm",), n_seeds=3, s=4.0, P=1, **kw):
    jj, tj = jobsets(names, n_seeds, **kw)
    seeds = np.tile(np.arange(n_seeds, dtype=np.uint32), len(names))
    return (jfabric.build_table(jj, s, P, seeds),
            tfabric.build_table(tj, s, P, seeds))


def assert_trials_equal(jres, tres, rows):
    """Every summary of the JAX and port results, bit for bit (nan
    equal to nan) on the trial ``rows``, key for key."""
    assert set(jres.stats) == set(tres.stats)
    for k in jres.stats:
        want, got = np.asarray(jres.stats[k]), tres.stats[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got[rows], want[rows], err_msg=k)


def comparable(jres_per_job, tres):
    """Trial rows to compare: the JAX trials without a fallback (each
    must be a port lane no draw decided), plus every port lane no draw
    decided."""
    drawn = tres.engine_stats["lane_drawn"]
    jax_clean = np.asarray(jres_per_job.stats["fallback_count"]) == 0
    assert not (jax_clean & (drawn > 0)).any()
    return np.flatnonzero(jax_clean | (drawn == 0))


def run_both(policy, mode, names=("burst-storm",), n_seeds=3,
             backfill=False, **kw):
    """The JAX and the port run_table, per_job and percentiles."""
    jcfg, tcfg = configs(policy, backfill=backfill, **kw)
    jt, tt = tables(names, n_seeds, backfill=backfill, **kw)
    out = {}
    for summary in ("per_job", "percentiles"):
        out[summary] = (
            jfabric.run_table(jcfg, jt, devices=1, time_mode=mode,
                              out=summary, donate=False),
            tfabric.run_table(tcfg, tt, time_mode=mode, out=summary,
                              device="cpu"))
    return out


@pytest.mark.parametrize("policy,mode", _slow_but_first(
    [(p, m) for p in EXACT for m in MODES]))
def test_run_table_matches_jax(policy, mode):
    out = run_both(policy, mode)
    rows = comparable(*out["per_job"])
    assert len(rows) > 0
    for jres, tres in out.values():
        assert_trials_equal(jres, tres, rows)
        assert (tres.n_trials, tres.n_padded, tres.n_devices, tres.out,
                tres.time_mode) == (3, 0, 1, jres.out, mode)
    # no draw at all for the deterministic policies: every trial agrees
    if policy in ("fifo", "lrtp", "srtp"):
        assert len(rows) == 3


@pytest.mark.parametrize("backfill", _slow_but_first([(False,), (True,)]))
def test_ragged_scenario_sweep_matches_jax(backfill):
    """te-flood, burst-storm and gang-heavy (gangs ride through the
    sentinel padding) in one table, fitgpp, with and without backfill:
    run_table per trial, and scenario_sweep's reshaped dict."""
    kw = dict(names=RAGGED, n_seeds=2, n_jobs=48)
    out = run_both("fitgpp", "event", backfill=backfill, **kw)
    rows = comparable(*out["per_job"])
    assert len(rows) > 0
    for jres, tres in out.values():
        assert_trials_equal(jres, tres, rows)
    jcfg, tcfg = configs("fitgpp", n_jobs=48, backfill=backfill)
    jout = jsweep.scenario_sweep(jcfg, RAGGED, [0, 1], devices=1)
    tout = tsweep.scenario_sweep(tcfg, RAGGED, [0, 1], device="cpu")
    assert set(jout) == set(tout)
    for k in jout:
        want = np.asarray(jout[k])
        assert tout[k].shape == want.shape == (3, 2) + want.shape[2:], k
        flat = tout[k].reshape((6,) + tout[k].shape[2:])
        np.testing.assert_array_equal(
            flat[rows], want.reshape(flat.shape)[rows], err_msg=k)
        # the wrapper is the fabric
        np.testing.assert_array_equal(flat, out["percentiles"][1].stats[k])


@pytest.mark.slow
def test_sensitivity_grid_matches_jax_shapes():
    """sensitivity_grid's keys, shapes and dtypes are the JAX module's;
    lrtp draws nothing, so every value agrees too."""
    jcfg, tcfg = configs("lrtp", max_preemptions=1)
    s_vals, seeds = (0.0, 2.0, 4.0), (0, 1)
    jout = jsweep.sensitivity_grid(jcfg, 64, s_vals, seeds, devices=1)
    tout = tsweep.sensitivity_grid(tcfg, 64, s_vals, seeds, device="cpu")
    assert set(jout) == set(tout)
    for k in jout:
        want = np.asarray(jout[k])
        assert tout[k].shape == want.shape and tout[k].dtype == want.dtype
        np.testing.assert_array_equal(tout[k], want, err_msg=k)


def _permuted(table, perm):
    jobs = table.jobs.map(lambda x: x[perm])
    return tfabric.TrialTable(jobs, table.s[perm], table.P[perm],
                              table.seed[perm], table.n_valid)


def _run_state(cfg, table, mode="event", stats=None):
    return sim_batch.state_to_numpy(sim_batch.run(
        cfg, table.jobs, table.s, table.P, table.seed, time_mode=mode,
        stats=stats))


@pytest.mark.parametrize("policy", ALL)
def test_batch_invariance(policy):
    """A trial's State is the same alone, in a batch and in any order of
    the batch, for every policy, RAND included (counter-based draws),
    every field bit for bit, the draw counts too."""
    _, tcfg = configs(policy)
    seeds = np.arange(3, dtype=np.uint32)
    _, tj = jobsets()
    table = tfabric.build_table(tj * 2, np.repeat(
        np.float32([0.0, 4.0]), 3), 1, np.tile(seeds, 2))
    whole = _run_state(tcfg, table)
    perm = np.array([4, 0, 5, 2, 1, 3])
    shuffled = _run_state(tcfg, _permuted(table, perm))
    for k in whole:
        np.testing.assert_array_equal(shuffled[k], whole[k][perm], k)
    for b in range(6):
        alone = _run_state(tcfg, _permuted(table, np.array([b])))
        for k in whole:
            np.testing.assert_array_equal(alone[k][0], whole[k][b], k)
    if policy in ("rand", "fitgpp", "minsize"):
        assert (whole["draws"] > 0).any()


def test_uniforms_depend_on_seed_count_and_job_only():
    seed = torch.tensor([0, 7, 7, 123456789], dtype=torch.int64)
    count = torch.tensor([0, 0, 3, 2 ** 33 + 5], dtype=torch.int64)
    u = sim_batch.uniforms(seed, count, 1000)
    assert u.dtype == torch.float64 and u.shape == (4, 1000)
    assert bool(((u >= 0) & (u < 1)).all())
    # a row depends on its own (seed, count) only
    for b in range(4):
        torch.testing.assert_close(
            sim_batch.uniforms(seed[b:b + 1], count[b:b + 1], 1000)[0],
            u[b], rtol=0, atol=0)
    assert len({tuple(r.tolist()) for r in u}) == 4
    # job j's draw does not depend on how many jobs the row has
    torch.testing.assert_close(sim_batch.uniforms(seed, count, 10),
                               u[:, :10], rtol=0, atol=0)
    assert abs(float(u.mean()) - 0.5) < 0.02


@pytest.mark.parametrize("policy", EXACT)
def test_lanes_equal_sim_torch(policy):
    """Every lane no draw decided equals sim_torch.run on its trial,
    State field for field, and its iteration counts equal the
    single-trial loop's; gang-heavy with backfill at 24 nodes, ragged
    against te-flood."""
    names, n_jobs, nodes = ("gang-heavy", "te-flood"), 48, 24
    _, tcfg = configs(policy, n_jobs=n_jobs, nodes=nodes, backfill=True)
    _, tj = jobsets(names, 2, n_jobs=n_jobs, nodes=nodes)
    table = tfabric.build_table(tj, 4.0, 1, [0, 1, 0, 1])
    stats = {}
    st = _run_state(tcfg, table, stats=stats)
    compared = 0
    for b, js in enumerate(tj):
        if stats["lane_drawn"][b]:
            continue
        sst = {}
        ref = sim_torch.state_to_numpy(sim_torch.run(
            dataclasses.replace(tcfg, s=4.0, max_preemptions=1),
            sim_torch.jobs_from_jobset(js, "cpu"), b % 2, stats=sst))
        lane = sim_batch.lane(st, b)
        for k, v in lane.items():
            got = v[:js.n] if np.ndim(v) and k not in ("free",
                                                       "pending_free") else v
            np.testing.assert_array_equal(got, ref[k], err_msg=k)
        # the padding rows stay sentinels
        assert (lane["state"][js.n:] == DONE).all()
        assert stats["lane_iterations"][b] == sst["iterations"]
        assert stats["lane_acting"][b] == sst["acting_ticks"]
        compared += 1
    assert compared >= 2


class TestSentinelPadding:
    """``tests/test_sweep_fabric.py::TestSentinelPadding`` on the port."""

    def test_padded_rows_are_dropped_and_bit_exact(self):
        _, tcfg = configs()
        _, table = tables()
        plain = tfabric.run_table(tcfg, table, device="cpu")
        padded = tfabric.pad_table(table, 4)
        assert int(padded.s.shape[0]) == 4 and padded.n_valid == 3
        res = tfabric.run_table(tcfg, padded, device="cpu")
        assert res.n_trials == 4
        for k, v in plain.stats.items():
            np.testing.assert_array_equal(res.stats[k][:3], v, err_msg=k)

    def test_sentinel_trial_is_born_done(self):
        _, tcfg = configs()
        _, table = tables(n_seeds=2)
        padded = tfabric.pad_table(table, 3)
        res = tfabric.run_table(tcfg, padded, device="cpu")
        assert res.stats["makespan"][2] == 0
        assert res.engine_stats["lane_iterations"][2] == 0
        assert np.isnan(res.stats["te_slowdown"][2]).all()
        assert np.isnan(res.stats["preempted_frac"][2])

    def test_sentinel_rows_masked_from_pooled_tables(self):
        _, tcfg = configs()
        _, table = tables(n_seeds=2)
        padded = tfabric.pad_table(table, 3)
        ref = tfabric.run_table(tcfg, table, out="per_job", device="cpu")
        res = tfabric.run_table(tcfg, padded, out="per_job", device="cpu")
        assert tfabric.pooled_tables(res) == tfabric.pooled_tables(ref)

    def test_pad_table_noop_when_even(self):
        _, table = tables(n_seeds=3)
        assert tfabric.pad_table(table, 3) is table

    def test_build_table_validation(self):
        with pytest.raises(ValueError, match="empty"):
            tfabric.build_table([], 4.0, 1, 0)
        _, table = tables(n_seeds=2)
        with pytest.raises(ValueError, match="shape"):
            tfabric.table_from_stacked(table.jobs, np.zeros(3, np.float32),
                                       1, 0)
        with pytest.raises(ValueError, match="per_job"):
            tfabric.pooled_tables(tfabric.run_table(
                configs()[1], table, device="cpu"))

    def test_ragged_jobs_pad_with_sentinels(self):
        _, tj = jobsets(RAGGED, 1, n_jobs=48)
        jobs = tfabric.stack_jobsets(tj)
        n = [js.n for js in tj]
        assert jobs.submit.shape == (3, max(n))
        for b, nb in enumerate(n):
            assert bool(jobs.valid[b, :nb].all())
            assert not bool(jobs.valid[b, nb:].any())
            assert bool((jobs.width[b, nb:] == 1).all())
            np.testing.assert_array_equal(jobs.width[b, :nb].numpy(),
                                          tj[b].n_nodes)


def test_pooled_tables_match_reference_engine():
    """lrtp pooled over 3 workloads: the fabric's tables equal the
    port's reference engine's ``metrics.pooled_tables`` (slowdowns to
    f32, preemption accounting exactly; resched intervals excluded: the
    fabric pools each job's last gap, the reference every gap)."""
    n_seeds = 3
    _, tcfg = configs("lrtp", n_jobs=96)
    _, tj = jobsets(n_seeds=n_seeds, n_jobs=96)
    results = [tsimulator.simulate(dataclasses.replace(tcfg, seed=k), js)
               for k, js in enumerate(tj)]
    ref = tmetrics.pooled_tables({
        "slowdown": np.concatenate([r.slowdown for r in results]),
        "is_te": np.concatenate([r.is_te for r in results]),
        "preempt_count": np.concatenate([r.preempt_count for r in results]),
        "intervals": np.concatenate([r.resched_intervals for r in results])})
    table = tfabric.build_table(tj, 4.0, 1, np.arange(n_seeds))
    res = tfabric.run_table(tcfg, table, out="per_job", device="cpu")
    fab = tfabric.pooled_tables(res)
    assert set(fab) == set(ref)
    for cls in ("TE", "BE"):
        for p, v in ref[cls].items():
            np.testing.assert_allclose(fab[cls][p], v, rtol=1e-6,
                                       err_msg=f"{cls}/{p}")
    assert fab["preempted_frac"] == pytest.approx(ref["preempted_frac"],
                                                  abs=1e-12)
    for k in ("1", "2", ">=3"):
        assert fab["preempt_counts"][k] == pytest.approx(
            ref["preempt_counts"][k], abs=1e-12), k
    one = tfabric.pooled_tables(res, trials=[1])
    solo = tmetrics.pooled_tables({
        "slowdown": results[1].slowdown, "is_te": results[1].is_te,
        "preempt_count": results[1].preempt_count,
        "intervals": results[1].resched_intervals})
    np.testing.assert_allclose(one["BE"]["p50"], solo["BE"]["p50"],
                               rtol=1e-6)


def test_normalizers_per_row():
    """ops.normalizers over a (B, J, ...) batch gives each row's clamped
    pair, equal to the unbatched call on that row (held against the
    JAX wrapper by test_torch_schedule_step.py); a row without
    candidates gets the 1e-12 clamp."""
    rng = np.random.default_rng(5)
    B, J = 4, 50
    demand = torch.from_numpy(np.stack([
        rng.integers(1, 33, (B, J)), rng.integers(1, 257, (B, J)),
        rng.integers(0, 9, (B, J))], -1).astype(np.float32))
    gp = torch.from_numpy(rng.integers(0, 21, (B, J)).astype(np.float32))
    cand = torch.from_numpy(rng.random((B, J)) < 0.5)
    cand[2] = False
    cap = torch.tensor([32.0, 256.0, 8.0])
    max_sz, max_gp = tops.normalizers(demand, gp, cand, cap)
    assert max_sz.shape == max_gp.shape == (B,)
    for b in range(B):
        sz, g = tops.normalizers(demand[b], gp[b], cand[b], cap)
        assert float(max_sz[b]) == float(sz) and float(max_gp[b]) == float(g)
    assert float(max_sz[2]) == np.float32(1e-12) == float(max_gp[2])
    rows = tops.normalizers(demand, gp, cand, cap.expand(B, 3))
    assert torch.equal(rows[0], max_sz) and torch.equal(rows[1], max_gp)


@pytest.mark.slow
def test_rand_statistical():
    """RAND draws from different sources in the two fabrics: hold the
    pooled picture (mean slowdown, preemptions) over 8 seeds."""
    jcfg, tcfg = configs("rand")
    jt, tt = tables(n_seeds=8)
    jres = jfabric.run_table(jcfg, jt, devices=1, out="per_job",
                             donate=False)
    tres = tfabric.run_table(tcfg, tt, out="per_job", device="cpu")
    j_sd = np.nanmean(jres.stats["slowdown"])
    t_sd = np.nanmean(tres.stats["slowdown"])
    j_pre = int(jres.stats["preempt_count"].sum())
    t_pre = int(tres.stats["preempt_count"].sum())
    assert t_pre > 0
    assert 0.8 <= t_sd / j_sd <= 1.25
    assert 0.6 <= t_pre / j_pre <= 1.67


class TestMeshForSweep:
    def test_single_device_returns_none(self):
        assert tmesh.mesh_for_sweep(8, device="cpu") is None
        assert tapi.mesh_for_sweep(8, devices=1, device="cpu") is None

    def test_over_request_warns(self, monkeypatch):
        """On the CPU the host offers one process per core: a request
        beyond them warns and falls back to them."""
        monkeypatch.setattr(tmesh.os, "cpu_count", lambda: 2)
        with pytest.warns(UserWarning, match="requested"):
            assert tmesh.mesh_for_sweep(64, devices=8, device="cpu") == \
                ["cpu", "cpu"]
        monkeypatch.setattr(tmesh.os, "cpu_count", lambda: 1)
        with pytest.warns(UserWarning, match="SINGLE-DEVICE"):
            assert tmesh.mesh_for_sweep(64, devices=8, device="cpu") is None

    def test_capped_by_n_trials(self):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert tmesh.mesh_for_sweep(1, device="cpu") is None
            assert tmesh.mesh_for_sweep(1, devices=1, device="cpu") is None
            assert tmesh.mesh_for_sweep(3, devices=2, device="cpu") == \
                ["cpu", "cpu"]

    def test_several_cuda_devices_are_granted(self, monkeypatch):
        """On a host with several cards a sweep runs on one unless more
        are asked for; a request for several that are present names
        them, ``min(devices, n_trials)`` of them."""
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert tmesh.mesh_for_sweep(8, device="cuda:0") is None
            assert tmesh.mesh_for_sweep(8, devices=2, device="cuda:0") == \
                ["cuda:0", "cuda:1"]
            assert tmesh.mesh_for_sweep(3, devices=4, device="cuda:0") == \
                ["cuda:0", "cuda:1", "cuda:2"]
            assert tmesh.mesh_for_sweep(8, devices=1,
                                        device="cuda:0") is None
            assert tmesh.mesh_for_sweep(1, device="cuda:0") is None


def _selftest_table():
    """The JAX sweep selftest's grid at half its jobs: burst-storm on 8
    nodes, 32 jobs, 3 seeds x s in {0, 2, 4}, P = 1: 9 trials."""
    _, tcfg = configs("fifo", n_jobs=32)
    jobsets = [tscenarios.build("burst-storm", dataclasses.replace(
        tcfg, seed=k)) for k in range(3)]
    s = np.repeat(np.asarray([0.0, 2.0, 4.0], np.float32), 3)
    seeds = np.tile(np.arange(3, dtype=np.uint32), 3)
    return tcfg, tfabric.build_table(jobsets * 3, s, 1, seeds)


def _same_result(a, b):
    assert a.stats.keys() == b.stats.keys()
    for k in a.stats:
        assert a.stats[k].dtype == b.stats[k].dtype, k
        assert np.array_equal(a.stats[k], b.stats[k], equal_nan=True), k
    for k in ("lane_iterations", "lane_acting", "lane_drawn"):
        assert np.array_equal(a.engine_stats[k], b.engine_stats[k]), k


def test_sharded_run_table_equals_one_device(one_thread):
    """The JAX selftest's uneven grid (9 trials on 4 processes: 3
    sentinel trials) sharded over 4 CPU processes (``run_table``'s
    sharded path, one pool for the six runs) equals the one-device
    run bit for bit, per-job stats and per-lane counters, for fifo,
    fitgpp and lrtp in event and tick mode (draws included: fitgpp takes
    random fallbacks here, counter-based on the trial)."""
    from repro_torch.sharding import ShardPool
    cfg, table = _selftest_table()
    drawn = 0
    with ShardPool(["cpu"] * 4) as pool:
        for policy in ("fifo", "fitgpp", "lrtp"):
            pcfg = dataclasses.replace(cfg, policy=policy)
            for mode in MODES:
                one = tfabric.run_table(pcfg, table, time_mode=mode,
                                        out="per_job", device="cpu")
                got = pool.run(pcfg, table, time_mode=mode, out="per_job")
                _same_result(got, one)
                assert (got.n_trials, got.n_padded, got.n_devices) == \
                    (9, 3, 4)
                assert (one.n_padded, one.n_devices) == (0, 1)
                assert len(got.engine_stats["shards"]) == 4
                drawn += int(one.engine_stats["lane_drawn"].sum())
    assert drawn > 0


def test_run_table_devices_shards_over_processes(one_thread):
    """``devices=2`` on the CPU starts two processes for the call: the
    percentile summary equals the one-device run, and the result says
    how the table was split."""
    cfg, table = _selftest_table()
    cfg = dataclasses.replace(cfg, policy="fitgpp")
    one = tfabric.run_table(cfg, table, device="cpu")
    got = tfabric.run_table(cfg, table, devices=2, device="cpu")
    _same_result(got, one)
    assert (got.n_trials, got.n_padded, got.n_devices) == (9, 1, 2)
    assert got.engine_stats["passes"] == sum(
        sh["passes"] for sh in got.engine_stats["shards"])


def test_shard_table_pads_and_cuts_in_trial_order():
    cfg, table = _selftest_table()
    shards = tsharding.shard_table(table, 4)
    assert [int(sh.s.shape[0]) for sh in shards] == [3, 3, 3, 3]
    s = torch.cat([sh.s for sh in shards])
    assert torch.equal(s[:9], table.s) and not s[9:].any()
    valid = torch.cat([sh.jobs.valid for sh in shards])
    assert torch.equal(valid[:9], table.jobs.valid) and not valid[9:].any()
    assert all(sh.n_valid == 9 for sh in shards)


def test_api_exports_the_sweep_surface():
    for name in ("run_sweep", "run_table", "build_table", "pooled_tables",
                 "sensitivity_grid", "scenario_sweep", "mesh_for_sweep",
                 "SweepResult", "TrialTable"):
        assert getattr(tapi, name) is not None and name in tapi.__all__
    assert tapi.run_table is tfabric.run_table
    assert [f.name for f in dataclasses.fields(jfabric.SweepResult)] == [
        f.name for f in dataclasses.fields(tfabric.SweepResult)
        if f.name != "engine_stats"]
    assert tfabric.TrialTable._fields == jfabric.TrialTable._fields

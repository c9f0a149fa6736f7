"""The port's engine against the JAX engine and the numpy reference.

Paper-synthetic at 8 nodes, 256 jobs, seed 2, P = 2: contended enough
that every preemptive policy preempts, and no score policy reaches its
random fallback (asserted), so the two engines must agree exactly. The
port runs on the CPU here (plain PyTorch schedule pass); the kernel
path is held against the plain path on the card (``cuda`` marker)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import cluster as jcluster
from repro.core import sim_jax, simulator
from repro.core import workload as jworkload
from repro_torch import api as tapi
from repro_torch.configs import cluster as tcluster
from repro_torch.core import sim_torch
from repro_torch.kernels import ops as tops

NODES, N_JOBS, SEED, P = 8, 256, 2, 2
EXACT = ["fifo", "fitgpp", "minsize", "lrtp", "srtp"]
SCORE = ("fitgpp", "minsize")
MODES = ["event", "tick"]
COMPARED = [f for f in sim_jax.State._fields
            if f not in ("rng", "ev_buf", "ev_n")]


def configs(policy, seed=SEED, P=P, n_jobs=N_JOBS):
    kw = dict(policy=policy, seed=seed, max_preemptions=P)
    j = jcluster.SimConfig(cluster=jcluster.ClusterSpec(n_nodes=NODES),
                           workload=jcluster.WorkloadSpec(n_jobs=n_jobs),
                           **kw)
    t = tcluster.SimConfig(cluster=tcluster.ClusterSpec(n_nodes=NODES),
                           workload=tcluster.WorkloadSpec(n_jobs=n_jobs),
                           **kw)
    return j, t


@functools.lru_cache(maxsize=None)
def jobset(seed=SEED, n_jobs=N_JOBS):
    return jworkload.generate(configs("fifo", seed, n_jobs=n_jobs)[0])


@functools.lru_cache(maxsize=None)
def torch_run(policy, mode, seed=SEED, P=P):
    _, tcfg = configs(policy, seed, P)
    jobs = sim_torch.jobs_from_jobset(jobset(seed), "cpu")
    return jobs, sim_torch.run(tcfg, jobs, seed, time_mode=mode)


def jax_state_numpy(st):
    return {f: np.asarray(getattr(st, f)) for f in COMPARED}


def assert_fields_equal(want: dict, got: dict, ctx=""):
    diff = [f for f in COMPARED if not np.array_equal(want[f], got[f])]
    assert not diff, f"{ctx}: fields differ: {diff}"


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", EXACT)
def test_matches_jax_engine(policy, mode):
    jcfg, _ = configs(policy)
    jst = sim_jax.run_jit(jcfg, sim_jax.jobs_from_jobset(jobset()), SEED,
                          time_mode=mode)
    _, tst = torch_run(policy, mode)
    if policy in SCORE:     # the random fallback never fires here
        assert int(jst.fallback_count) == 0
    if policy != "fifo":
        assert int(np.asarray(jst.preempt_count).sum()) > 0
    assert_fields_equal(jax_state_numpy(jst), sim_torch.state_to_numpy(tst),
                        f"{policy}/{mode}")


@pytest.mark.parametrize("policy", EXACT)
def test_matches_reference_engine(policy):
    jcfg, _ = configs(policy)
    ref = simulator.simulate(jcfg, jobset(), mode="event")
    _, tst = torch_run(policy, "event")
    np.testing.assert_array_equal(tst.finish.numpy(), ref.finish)
    np.testing.assert_array_equal(tst.preempt_count.numpy(),
                                  ref.preempt_count)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", ["fitgpp", "lrtp"])
def test_single_step_parity(policy, mode):
    """Carry every JAX ``make_tick`` State of a run across, step both
    engines once from it, and compare the next States."""
    jcfg, tcfg = configs(policy)
    js = jobset()
    jj = sim_jax.jobs_from_jobset(js)
    tj = sim_torch.jobs_from_jobset(js, "cpu")
    jtick = jax.jit(sim_jax.make_tick(jcfg, jj, NODES, time_mode=mode))
    ttick = sim_torch.make_tick(tcfg, tj, NODES, time_mode=mode)
    st = sim_jax.init_state(jj, NODES, jcfg.cluster.node.as_tuple(), SEED)
    steps = 0
    while int(st.n_done) < N_JOBS and steps < 700:
        nxt = jtick(st)
        got = ttick(sim_torch.state_from_numpy(jax_state_numpy(st), SEED,
                                               "cpu"))
        assert_fields_equal(jax_state_numpy(nxt),
                            sim_torch.state_to_numpy(got),
                            f"{policy}/{mode} step {steps}")
        st, steps = nxt, steps + 1
    assert int(st.n_done) == N_JOBS


@pytest.mark.parametrize("policy,seed,P", [
    ("fifo", SEED, P), ("fitgpp", SEED, P), ("minsize", SEED, P),
    ("lrtp", SEED, P), ("srtp", SEED, P), ("rand", SEED, P),
    # P = 1 on seed 3: the random fallback fires, and must fire
    # identically in both time modes
    ("fitgpp", 3, 1), ("minsize", 3, 1), ("rand", 3, 1)])
def test_tick_equals_event(policy, seed, P):
    a = sim_torch.state_to_numpy(torch_run(policy, "tick", seed, P)[1])
    b = sim_torch.state_to_numpy(torch_run(policy, "event", seed, P)[1])
    assert sim_torch.state_diff_fields(a, b) == []
    if policy in ("fitgpp", "minsize") and P == 1:
        assert a["fallback_count"] > 0


@pytest.mark.parametrize("policy", ["fitgpp", "lrtp"])
def test_result_summary_matches_jax(policy):
    jcfg, _ = configs(policy)
    jj = sim_jax.jobs_from_jobset(jobset())
    want = sim_jax.result_summary(jj, sim_jax.run_jit(jcfg, jj, SEED))
    got = sim_torch.result_summary(*torch_run(policy, "event"))
    for k in ("TE", "BE", "intervals"):
        for p, v in want[k].items():
            np.testing.assert_allclose(got[k][p], float(v), rtol=1e-6,
                                       err_msg=f"{k}.{p}")
    np.testing.assert_allclose(got["preempted_frac"],
                               float(want["preempted_frac"]), rtol=1e-6)
    assert got["fallback_count"] == int(want["fallback_count"])


def test_golden_claim_on_torch_engine():
    """tests/test_paper_claims.py's headline lock, on the port: pooled
    over 5 seeded workloads, fitgpp cuts FIFO's TE p95 slowdown by at
    least 80%, at a bounded BE cost."""
    pooled = {}
    for policy in ("fifo", "fitgpp"):
        sd, te = [], []
        for seed in range(5):
            cfg = tapi.make_config(policy, n_nodes=8, n_jobs=256, seed=seed)
            r = tapi.run_experiment(policy=policy, cfg=cfg, device="cpu")
            sd.append(sim_torch.slowdown(r.raw.jobs, r.raw.state).numpy())
            te.append(r.raw.jobs.is_te.numpy())
        pooled[policy] = np.concatenate(sd), np.concatenate(te)
    (f_sd, f_te), (g_sd, g_te) = pooled["fifo"], pooled["fitgpp"]
    fifo_p95 = np.percentile(f_sd[f_te], 95)
    assert fifo_p95 > 5.0
    assert 1.0 - np.percentile(g_sd[g_te], 95) / fifo_p95 >= 0.80
    assert np.median(g_sd[~g_te]) / np.median(f_sd[~f_te]) - 1.0 <= 0.35
    assert np.percentile(g_sd[~g_te], 95) / np.percentile(
        f_sd[~f_te], 95) - 1.0 <= 0.50


def test_rand_statistical():
    """RAND draws from different generators in the two engines: hold
    the pooled picture (mean slowdown, preemptions) over seeds."""
    jcfg, tcfg = configs("rand")
    js = jobset()
    jj = sim_jax.jobs_from_jobset(js)
    tj = sim_torch.jobs_from_jobset(js, "cpu")
    j_sd, j_pre, t_sd, t_pre = [], [], [], []
    for seed in range(4):
        jst = sim_jax.run_jit(jcfg, jj, seed)
        tst = sim_torch.run(tcfg, tj, seed)
        j_sd.append(float(np.asarray(sim_jax.slowdown(jj, jst)).mean()))
        t_sd.append(float(sim_torch.slowdown(tj, tst).mean()))
        j_pre.append(int(np.asarray(jst.preempt_count).sum()))
        t_pre.append(int(tst.preempt_count.sum()))
        assert tst.n_done == N_JOBS
    assert 0.8 <= np.mean(t_sd) / np.mean(j_sd) <= 1.25
    assert 0.6 <= np.mean(t_pre) / np.mean(j_pre) <= 1.67


def test_api_result_mirrors_jax_api():
    assert [f.name for f in dataclasses.fields(tapi.ExperimentResult)] == \
        [f.name for f in dataclasses.fields(japi.ExperimentResult)]
    rs = tapi.compare_policies(["fifo", "fitgpp"], n_jobs=N_JOBS,
                               n_nodes=NODES, seed=SEED, P=P, device="cpu")
    for policy, r in rs.items():
        _, tst = torch_run(policy, "event")
        assert r.makespan == tst.t and r.policy == policy
        np.testing.assert_array_equal(r.raw.state.finish.numpy(),
                                      tst.finish.numpy())
        assert r.raw.launches == 0 and r.raw.iterations > 0
        summary = sim_torch.result_summary(r.raw.jobs, r.raw.state)
        assert r.table == {k: summary[k] for k in ("TE", "BE")}


def test_state_round_trip_with_gangs():
    """A State round-trips through numpy; so do gang jobs and a
    multi-node ``assign`` mask."""
    jobs, st = torch_run("fitgpp", "event")
    d = sim_torch.state_to_numpy(st)
    back = sim_torch.state_to_numpy(sim_torch.state_from_numpy(d, SEED,
                                                               "cpu"))
    assert sim_torch.state_diff_fields(
        {k: v for k, v in d.items() if k != "rng"},
        {k: v for k, v in back.items() if k != "rng"}) == []
    gang = dict(submit=[0, 1], exec_total=[5, 3],
                demand=[[4.0, 16.0, 2.0], [1.0, 1.0, 0.0]],
                is_te=[False, True], gp=[2, 0], width=[3, 1])
    gjobs = sim_torch.jobs_from_numpy(gang, "cpu")
    assert gjobs.width.tolist() == [3, 1]
    gst = sim_torch.init_state(gjobs, 4, (32.0, 256.0, 8.0), SEED)
    gst.assign[0, :3] = True
    gst.state[0] = 2
    d = sim_torch.state_to_numpy(gst)
    back = sim_torch.state_to_numpy(sim_torch.state_from_numpy(d, SEED,
                                                               "cpu"))
    assert sim_torch.state_diff_fields(d, back) == []
    assert back["assign"].sum() == 3


@pytest.mark.cuda
def test_kernel_path_equals_plain_path_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    _, tcfg = configs("fitgpp", 3, 1)
    jobs = sim_torch.jobs_from_jobset(jobset(3), "cuda")
    before = tops.LAUNCHES["schedule_step"]
    kern = sim_torch.state_to_numpy(sim_torch.run(tcfg, jobs, 3))
    assert tops.LAUNCHES["schedule_step"] > before
    monkeypatch.setattr(tops, "_FORCE_PLAIN", True)
    plain = sim_torch.state_to_numpy(sim_torch.run(tcfg, jobs, 3))
    assert sim_torch.state_diff_fields(kern, plain) == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_argmin_argmax_key_ties_match_jax(seed):
    """``_argmin_key``/``_argmax_key`` with a permuted ``akey`` pick
    what ``sim_jax``'s do (the smallest akey among tied extrema), and
    without one the first extremum; rows of a batch reduce alone."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n = int(rng.integers(1, 40))
        mask = rng.random(n) < 0.6
        val = rng.integers(0, 3, n).astype(np.float32)
        akey = rng.permutation(n).astype(np.float32)
        for key in (None, akey):
            jkey = None if key is None else jnp.asarray(key)
            tkey = None if key is None else torch.from_numpy(key)
            for tfn, jfn in ((sim_torch._argmin_key, sim_jax._argmin_key),
                             (sim_torch._argmax_key, sim_jax._argmax_key)):
                want = int(jfn(jnp.asarray(mask), jnp.asarray(val), jkey))
                got = tfn(torch.from_numpy(mask), torch.from_numpy(val),
                          tkey)
                assert int(got) == want
    masks = torch.from_numpy(rng.random((3, 16)) < 0.5)
    vals = torch.from_numpy(rng.integers(0, 2, (3, 16)).astype(np.float32))
    keys = torch.from_numpy(np.stack([rng.permutation(16)
                                      for _ in range(3)]).astype(np.float32))
    rows = sim_torch._argmin_key(masks, vals, keys)
    assert rows.tolist() == [int(sim_torch._argmin_key(m, v, k))
                             for m, v, k in zip(masks, vals, keys)]


@pytest.mark.parametrize("policy,mode", [("fitgpp", "event"),
                                         ("lrtp", "tick"),
                                         ("srtp", "event")])
def test_akey_in_index_order_leaves_the_engine_unchanged(policy, mode):
    """``Jobs.akey`` equal to the row index runs the same engine as no
    ``akey`` (the monolithic order), field for field."""
    _, tcfg = configs(policy)
    jobs = sim_torch.jobs_from_jobset(jobset(), "cpu")
    keyed = dataclasses.replace(
        jobs, akey=torch.arange(N_JOBS, dtype=torch.float32))
    want = sim_torch.state_to_numpy(torch_run(policy, mode)[1])
    got = sim_torch.state_to_numpy(sim_torch.run(tcfg, keyed, SEED,
                                                 time_mode=mode))
    assert sim_torch.state_diff_fields(want, got) == []


@pytest.mark.parametrize("policy,mode", [("fitgpp", "event"),
                                         ("lrtp", "tick"),
                                         ("srtp", "event"),
                                         ("fifo", "event")])
def test_permuted_rows_with_akey_equal_the_ordered_run(policy, mode):
    """Rows in any order with ``akey`` holding their arrival order give
    the ordered run's State, row for row: the tie-breaks, arrival keys
    and requeue ranks follow ``akey``, as on the stream engine's
    recycled slots. (Preemptions happen here, so the victim and vacate
    ties are exercised.)"""
    _, tcfg = configs(policy)
    js = jobset()
    perm = np.random.default_rng(7).permutation(N_JOBS)
    arrays = dict(submit=js.submit[perm], exec_total=js.exec_total[perm],
                  demand=js.demand[perm], is_te=js.is_te[perm],
                  gp=js.gp[perm], width=js.n_nodes[perm],
                  akey=perm.astype(np.float32))
    st = sim_torch.run(tcfg, sim_torch.jobs_from_numpy(arrays, "cpu"), SEED,
                       time_mode=mode)
    want = sim_torch.state_to_numpy(torch_run(policy, mode)[1])
    got = sim_torch.state_to_numpy(st)
    inv = np.argsort(perm)
    assert want["preempt_count"].sum() > 0 or policy == "fifo"
    for f in COMPARED:
        x = got[f]
        if x.ndim and x.shape[0] == N_JOBS:
            x = x[inv]
        if f == "victim_of":
            x = np.where(x >= 0, perm[np.maximum(x, 0)], x)
        np.testing.assert_array_equal(x, want[f], err_msg=f)

"""The port's stream engine (``repro_torch.core.stream``) against the
JAX package's (``repro.core.stream``), on the CPU.

The cases of ``tests/test_stream.py`` at its sizes (8 nodes, 200-400
jobs, pools of 16-160 slots), on the port: the parity window against
the port's own monolithic ``sim_torch.run`` (fitgpp/event and
lrtp/tick; the full matrices ``slow`` as in JAX), no gid lost or
duplicated across capacities, the spill's order and the refusal of a
spilled run, the ``AKEY_GID_LIMIT`` guard, closed-loop admission (admit
times bit-exact and chunk-invariant, engine parity), the traced drain
with its ``event_sink`` CSV path, ``round_capacity``, ``get_source``
against ``build`` and the trace readers. Beyond those, the port's
``StreamResult`` and its remapped events equal the JAX ``StreamEngine``'s
field for field and event for event at the same capacity (the slot
placement is deterministic), the sources and ``run_stream`` equal
JAX's. The runs compared with JAX draw no random fallback (score
policies) and use no RAND, whose draws differ between the engines; the
parity window against the port's own monolithic run holds with draws."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import api as japi
from repro import scenarios as jscenarios
from repro.core import stream as jstream
from repro.core import workload as jworkload
from repro.scenarios import traces as jtraces
from repro_torch import api as tapi
from repro_torch import scenarios as tscenarios
from repro_torch.core import stream as tstream
from repro_torch.core import workload as tworkload
from repro_torch.core.types import JobSet
from repro_torch.obs import export, ring, schema, timeseries
from repro_torch.scenarios import traces as ttraces
from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*shard_map.*:DeprecationWarning")

CPU = "cpu"
RESULT_ARRAYS = ("submit", "exec_total", "is_te", "width", "finish",
                 "preempt_count", "last_signal", "last_vacate",
                 "last_resume")
RESULT_SCALARS = ("n_jobs", "capacity", "rounds", "makespan",
                  "fallback_count", "trace_overflow", "max_live",
                  "n_spilled", "spill_peak")
JOBSET_FIELDS = ("submit", "exec_total", "demand", "is_te", "gp", "n_nodes")


def _cfg(policy="fitgpp", n_jobs=400, n_nodes=8, seed=0, load=0.5,
         api=tapi):
    cfg = api.make_config(policy, n_jobs=n_jobs, n_nodes=n_nodes,
                          seed=seed)
    return dataclasses.replace(
        cfg, workload=dataclasses.replace(cfg.workload, load=load))


def _src(cfg, n_jobs, chunk=64):
    return tstream.JobSource(tworkload.stream_chunks(cfg, n_jobs,
                                                     chunk=chunk))


def _events(events):
    return [(e.t, e.code, e.job, e.aux, tuple(e.nodes)) for e in events]


def assert_jobsets_equal(a, b, ctx=""):
    assert a.n == b.n, ctx
    for f in JOBSET_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{ctx}: {f}")


def assert_results_equal(jres, tres, ctx=""):
    for f in RESULT_ARRAYS:
        np.testing.assert_array_equal(getattr(tres, f), getattr(jres, f),
                                      err_msg=f"{ctx}: {f}")
    for f in RESULT_SCALARS:
        assert getattr(tres, f) == getattr(jres, f), f"{ctx}: {f}"


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("policy,mode", [("fitgpp", "event"),
                                         ("lrtp", "tick")])
def test_parity_window(policy, mode):
    """Streamed == monolithic ``sim_torch.run``, bit for bit, with slot
    recycling (a pool of 96 slots for 400 jobs)."""
    assert tstream.verify_prefix_parity(
        _cfg(policy), n_jobs=400, capacity=96, chunk=64, time_mode=mode,
        device=CPU) == []


@pytest.mark.parametrize("policy,load,capacity", [("rand", 0.5, 96),
                                                  ("fitgpp", 0.9, 160)])
def test_parity_window_with_draws(policy, load, capacity):
    """Draws hash each job's global sequence number, not its slot: RAND
    and a score policy's random fallback stream as they run
    monolithically, draw count and fallback count included."""
    cfg = dataclasses.replace(_cfg(policy, n_jobs=400, load=load),
                              max_preemptions=1)
    res = tstream.StreamEngine(cfg, _src(cfg, 400), capacity=capacity,
                               device=CPU).run()
    assert res.final_draws > 0 and res.n_spilled == 0
    if policy == "fitgpp":
        assert res.fallback_count > 0
    assert tstream.verify_prefix_parity(
        cfg, n_jobs=400, capacity=capacity, chunk=64, device=CPU) == []


@pytest.mark.slow
@pytest.mark.parametrize("policy,mode", [("fitgpp", "tick"),
                                         ("lrtp", "event"),
                                         ("srtp", "event"),
                                         ("fifo", "event")])
def test_parity_window_full_matrix(policy, mode):
    assert tstream.verify_prefix_parity(
        _cfg(policy), n_jobs=400, capacity=96, chunk=64, time_mode=mode,
        device=CPU) == []


@pytest.mark.parametrize("policy,mode,load,capacity,admission", [
    ("fitgpp", "event", 0.5, 96, None),
    ("lrtp", "tick", 0.5, 96, None),
    ("srtp", "event", 2.0, 64, True),
    ("fifo", "tick", 2.0, 160, True)])
def test_matches_jax_stream_engine(policy, mode, load, capacity,
                                   admission):
    """The port's traced StreamResult equals the JAX StreamEngine's at
    the same capacity: every per-job array, rounds, peak live jobs,
    makespan and counters, and the remapped events one for one."""
    jcfg = _cfg(policy, n_jobs=300, load=load, api=japi)
    tcfg = _cfg(policy, n_jobs=300, load=load)
    jres = jstream.StreamEngine(
        jcfg, jstream.JobSource(jworkload.stream_chunks(jcfg, 300,
                                                        chunk=64)),
        capacity=capacity, time_mode=mode, trace=True,
        admission=admission).run()
    tres = tstream.StreamEngine(
        tcfg, _src(tcfg, 300), capacity=capacity, time_mode=mode,
        trace=True, admission=admission, device=CPU).run()
    assert jres.fallback_count == 0 and jres.rounds > 1
    assert_results_equal(jres, tres, policy)
    assert _events(tres.events) == _events(jres.events)
    # the same numbers, nan (an empty class) included
    assert repr(tres.summary()) == repr(jres.summary())


# ------------------------------------------------- recycling invariants

def test_no_gid_lost_or_duplicated_across_capacities():
    """Different capacities recycle slots differently; the per-gid
    results do not change by one bit, and every gid comes back once."""
    cfg = _cfg(n_jobs=300)
    results = {cap: tstream.StreamEngine(cfg, _src(cfg, 300), capacity=cap,
                                         device=CPU).run()
               for cap in (96, 160)}
    a, b = results[96], results[160]
    assert a.n_jobs == b.n_jobs == 300
    assert a.rounds > 1 and b.rounds > 1
    assert a.max_live <= 96 and b.max_live <= 160
    for f in RESULT_ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert (a.finish >= a.submit).all()


def test_pool_starvation_spills_in_order():
    """A saturating load overflows a 16-slot pool: overdue arrivals
    spill to the host queue in order and the run completes; every gid's
    job data equals the materialized stream, and the spilled run equals
    the JAX engine's spilled run."""
    cfg = _cfg(n_jobs=200, load=2.0)
    res = tstream.StreamEngine(cfg, _src(cfg, 200), capacity=16,
                               device=CPU).run()
    assert res.n_jobs == 200
    assert res.n_spilled > 0 and res.spill_peak > 0
    assert res.max_live <= 16
    data = tstream.materialize(_src(cfg, 200))
    np.testing.assert_array_equal(res.submit, data.submit)
    np.testing.assert_array_equal(res.exec_total, data.exec_total)
    assert (res.finish >= res.submit + res.exec_total).all()
    assert res.summary()["n_spilled"] == res.n_spilled
    jcfg = _cfg(n_jobs=200, load=2.0, api=japi)
    jres = jstream.StreamEngine(
        jcfg, jstream.JobSource(jworkload.stream_chunks(jcfg, 200,
                                                        chunk=64)),
        capacity=16).run()
    assert_results_equal(jres, res, "spilled")


def test_spilled_run_rejected_by_parity_window():
    with pytest.raises(ValueError, match="spill"):
        tstream.verify_prefix_parity(_cfg(n_jobs=200, load=2.0),
                                     n_jobs=200, capacity=16, chunk=64,
                                     device=CPU)


def test_akey_gid_limit_guard():
    """gids ride in float32 ``akey``; the pack refuses past 2^24 (forged
    through ``_reset``, not by streaming 16M jobs)."""
    cfg = _cfg(n_jobs=64)

    class Forged(tstream.StreamEngine):
        def _reset(self):
            super()._reset()
            self._n_seen = tstream.AKEY_GID_LIMIT - 8

    with pytest.raises(RuntimeError, match=r"2\^24"):
        Forged(cfg, _src(cfg, 64, chunk=32), capacity=96, device=CPU).run()


def test_stream_engine_runs_on_the_card_by_default(monkeypatch):
    """Without CUDA and without ``device`` the stream's entry points
    raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(n_jobs=64)
    for call in (lambda: tstream.StreamEngine(cfg, _src(cfg, 64)),
                 lambda: tstream.verify_prefix_parity(cfg, n_jobs=64),
                 lambda: tapi.run_stream("burst-storm", n_jobs=8,
                                         n_nodes=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ------------------------------------------------- closed-loop admission

@pytest.mark.parametrize("mode", ["tick", "event"])
def test_admission_admit_times_bit_exact(mode):
    """ClosedLoopAdmission's admit ticks equal the monolithic
    ``closed_loop_submit_times`` and the JAX controller's, bit for bit;
    the job data passes through untouched."""
    cfg = dataclasses.replace(_cfg(load=2.0), time_mode=mode)
    assert tstream.verify_admission_parity(cfg, n_jobs=400, chunk=64) == []
    jcfg = dataclasses.replace(_cfg(load=2.0, api=japi), time_mode=mode)
    want = jstream.materialize(jstream.JobSource(jstream.ClosedLoopAdmission(
        jcfg, jstream.JobSource(jworkload.stream_chunks(jcfg, 400,
                                                        chunk=64)),
        chunk=64)))
    got = tstream.materialize(tstream.JobSource(tstream.ClosedLoopAdmission(
        cfg, _src(cfg, 400), chunk=64)))
    assert_jobsets_equal(got, want, mode)


def test_admission_chunk_invariant():
    cfg = _cfg(load=2.0)
    outs = [tstream.materialize(tstream.JobSource(
        tstream.ClosedLoopAdmission(cfg, _src(cfg, 300), chunk=chunk)))
        for chunk in (16, 64, 512)]
    for js in outs[1:]:
        np.testing.assert_array_equal(js.submit, outs[0].submit)


@pytest.mark.parametrize("policy,mode", [("fifo", "event"),
                                         ("lrtp", "tick")])
def test_closed_loop_engine_parity(policy, mode):
    """The whole streamed closed-loop path, admission and macro-rounds,
    equals the monolithic pipeline bit for bit."""
    assert tstream.verify_closed_loop_parity(
        _cfg(policy, load=2.0), n_jobs=400, capacity=160, chunk=64,
        time_mode=mode, device=CPU) == []


@pytest.mark.slow
@pytest.mark.parametrize("policy,mode", [("fifo", "tick"),
                                         ("lrtp", "event"),
                                         ("srtp", "tick"),
                                         ("srtp", "event")])
def test_closed_loop_engine_parity_full_matrix(policy, mode):
    assert tstream.verify_closed_loop_parity(
        _cfg(policy, load=2.0), n_jobs=400, capacity=160, chunk=64,
        time_mode=mode, device=CPU) == []


@pytest.mark.slow
def test_closed_loop_golden_load2():
    """Paper §4.2 at load 2.0, streamed end to end: FitGpp cuts FIFO's
    TE p95 by at least 80% with the BE median within 35%."""
    res = {}
    for policy in ("fifo", "fitgpp"):
        cfg = _cfg(policy, n_jobs=2000, load=2.0)
        r = tstream.StreamEngine(cfg, _src(cfg, 2000, chunk=256),
                                 capacity=1024, admission=True,
                                 device=CPU).run()
        assert r.n_spilled == 0
        res[policy] = r.summary()
    fifo_te95 = res["fifo"]["TE"]["p95"]
    assert fifo_te95 > 5.0
    assert res["fitgpp"]["TE"]["p95"] < 0.2 * fifo_te95
    assert res["fitgpp"]["BE"]["p50"] <= 1.35 * res["fifo"]["BE"]["p50"]


# ------------------------------------------------------ per-round drain

def test_streamed_trace_decomposition_and_drain(tmp_path):
    """One traced streamed run: valid gid-remapped events, the slowdown
    decomposition's identity for every job, no overflow at the default
    per-round ring, and the per-round CSV sink equal to the in-memory
    stream."""
    cfg = _cfg(n_jobs=300)
    res = tstream.StreamEngine(cfg, _src(cfg, 300), capacity=96,
                               trace=True, device=CPU).run()
    assert res.trace_overflow == 0
    schema.validate_events(res.events, n_jobs=res.n_jobs,
                           n_nodes=cfg.cluster.n_nodes)
    dec = timeseries.slowdown_decomposition(res.events)
    assert len(dec) == res.n_jobs
    for gid, d in dec.items():
        assert d.identity_holds(), f"identity broken for gid {gid}"
        assert d.finish == int(res.finish[gid])
        assert d.submit == int(res.submit[gid])
    path = tmp_path / "trace.csv"
    with export.CsvTraceWriter(str(path)) as w:
        res2 = tstream.StreamEngine(cfg, _src(cfg, 300), capacity=96,
                                    trace=True, event_sink=w.write,
                                    device=CPU).run()
    assert res2.events is None
    assert w.n_written == len(res.events)
    assert export.read_csv(path.read_text()) == res.events


def test_result_sink_streams_the_results():
    """With a ``result_sink`` the per-job results leave round by round
    (gid-tagged batches) and the result holds none."""
    cfg = _cfg(n_jobs=200)
    batches = []
    res = tstream.StreamEngine(cfg, _src(cfg, 200), capacity=64,
                               result_sink=batches.append, device=CPU).run()
    want = tstream.StreamEngine(cfg, _src(cfg, 200), capacity=64,
                                device=CPU).run()
    assert res.finish.size == 0 and len(batches) > 1
    gid = np.concatenate([b["gid"] for b in batches])
    order = np.argsort(gid)
    np.testing.assert_array_equal(gid[order], np.arange(200))
    for f in RESULT_ARRAYS:
        np.testing.assert_array_equal(
            np.concatenate([b[f] for b in batches])[order],
            getattr(want, f), f)


def test_round_capacity_sizes_off_slots():
    assert ring.round_capacity(128, 2) == ring.default_capacity(128, 2)
    assert ring.round_capacity(256, 1) < ring.default_capacity(100_000, 1)
    cfg = _cfg(n_jobs=64)
    eng = tstream.StreamEngine(cfg, _src(cfg, 64), capacity=128,
                               device=CPU)
    assert eng.trace_capacity == ring.round_capacity(128,
                                                     cfg.max_preemptions)
    assert tstream.default_capacity(cfg) == max(
        64, tstream.DEFAULT_SLOTS_PER_NODE * 8 * cfg.max_preemptions)


# ------------------------------------------------------------- sources

def _sourced():
    return [n for n in tscenarios.scenario_names()
            if tscenarios.get_scenario(n).source is not None]


def test_registered_sources_match_jax():
    """The same scenarios register a streaming source as in JAX."""
    assert _sourced() == [n for n in jscenarios.scenario_names()
                          if jscenarios.get_scenario(n).source is not None]
    assert len(_sourced()) == 6


@pytest.mark.parametrize("name", ["philly-sample", "pai-sample",
                                  "philly-tiled", "pai-tiled",
                                  "stream-synthetic", "stream-closed-loop",
                                  "burst-storm", "gang-heavy"])
def test_get_source_matches_jax_and_build(name):
    """``get_source`` streams the JAX package's jobs, and (materialized
    fallback or not) what ``build`` materializes."""
    tcfg = _cfg(n_jobs=120)
    jcfg = _cfg(n_jobs=120, api=japi)
    got = tstream.materialize(tscenarios.get_source(name, tcfg))
    assert_jobsets_equal(got, jstream.materialize(
        jscenarios.get_source(name, jcfg)), f"{name} vs JAX")
    if name not in ("philly-sample", "pai-sample"):   # gp drawn per chunk
        assert_jobsets_equal(got, tscenarios.build(name, tcfg),
                             f"{name} vs build")


@pytest.mark.parametrize("path,dialect,loader", [
    (ttraces.PHILLY_SAMPLE, "philly", ttraces.load_philly_csv),
    (ttraces.PAI_SAMPLE, "pai", ttraces.load_pai_csv)])
def test_trace_reader_matches_monolithic(path, dialect, loader):
    """``trace_source``: the rows, normalization and drop counts of the
    monolithic loader in one pass (gp is drawn per chunk), and the JAX
    ``trace_source``'s jobs and counts."""
    cfg = _cfg()
    mono, mstats = loader(path, cfg, return_stats=True)
    src = ttraces.trace_source(path, cfg, dialect, chunk=7)
    got = tstream.materialize(src)
    for f in ("submit", "exec_total", "demand", "is_te", "n_nodes"):
        np.testing.assert_array_equal(getattr(got, f), getattr(mono, f), f)
    assert src.stats == mstats
    jpath = {"philly": jtraces.PHILLY_SAMPLE, "pai": jtraces.PAI_SAMPLE}
    jsrc = jtraces.trace_source(jpath[dialect], _cfg(api=japi), dialect,
                                chunk=7)
    assert_jobsets_equal(got, jstream.materialize(jsrc), dialect)
    assert dataclasses.asdict(src.stats) == dataclasses.asdict(jsrc.stats)


def test_tiled_fixture_stream():
    cfg = _cfg(n_jobs=120)
    js = tstream.materialize(
        ttraces.tiled_source(ttraces.PHILLY_SAMPLE, cfg, "philly",
                             repeats=5))
    assert js.n == 5 * 26 and (np.diff(js.submit) >= 0).all()
    built = tscenarios.build("philly-tiled", cfg)
    assert built.n >= 120 and built.n == -(-120 // 26) * 26


def test_stream_of_hand_made_chunks():
    """A stream of hand-made chunks with one slot per job in flight:
    jobs of equal submit time recycle slots in gid order."""
    def chunk(submits):
        n = len(submits)
        return JobSet(submit=np.asarray(submits, np.int64),
                      exec_total=np.full(n, 5, np.int64),
                      demand=np.tile([1.0, 1.0, 1.0], (n, 1)),
                      is_te=np.zeros(n, bool), gp=np.zeros(n, np.int64),
                      n_nodes=np.ones(n, np.int64))

    cfg = _cfg("fifo", n_jobs=6)
    src = tstream.JobSource([chunk([0, 0, 1]), chunk([1, 9, 9])])
    res = tstream.StreamEngine(cfg, src, capacity=64, device=CPU).run()
    np.testing.assert_array_equal(res.submit, [0, 0, 1, 1, 9, 9])
    np.testing.assert_array_equal(res.finish, res.submit + 5)
    assert res.n_spilled == 0 and res.makespan == 14


# --------------------------------------------------------------- facade

def test_run_stream_api_matches_jax():
    """``api.run_stream`` on the CPU: the JAX facade's table, intervals,
    makespan and per-job results, ``engine="stream"``."""
    want = japi.run_stream("philly-tiled", "fitgpp", n_jobs=120, n_nodes=8)
    got = tapi.run_stream("philly-tiled", "fitgpp", n_jobs=120, n_nodes=8,
                          device=CPU)
    assert got.engine == "stream"
    assert got.raw.n_jobs == len(got.raw.finish) == 130
    assert got.table == want.table and got.intervals.keys() \
        == want.intervals.keys()
    assert got.makespan == want.makespan > 0
    assert got.preempted_frac == want.preempted_frac
    assert_results_equal(want.raw, got.raw, "run_stream")
    closed = tapi.run_stream("stream-synthetic", "lrtp", n_jobs=200,
                             n_nodes=8, capacity=128, admission=True,
                             trace=True, device=CPU)
    jclosed = japi.run_stream("stream-synthetic", "lrtp", n_jobs=200,
                              n_nodes=8, capacity=128, admission=True,
                              trace=True)
    assert_results_equal(jclosed.raw, closed.raw, "closed-loop")
    assert _events(closed.events) == _events(jclosed.events)

"""The port's ``repro_torch.obs`` against the JAX package's ``repro.obs``
on the same inputs, exactly: the schema's verdicts and renderings, the
ring layout helpers and decode (from numpy and from a torch tensor),
the CSV and Perfetto exports, and the replayed time series and slowdown
decomposition of a JAX-traced, preemption-heavy stream."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro.configs import cluster as jcluster
from repro.core import sim_jax
from repro.core.types import PreemptionEvent
from repro.obs import export as jexport
from repro.obs import ring as jring
from repro.obs import schema as jschema
from repro.obs import timeseries as jts
from repro_torch import obs as tobs
from repro_torch.obs import export as texport
from repro_torch.obs import ring as tring
from repro_torch.obs import schema as tschema
from repro_torch.obs import timeseries as tts

N_NODES = 16


@pytest.fixture(scope="module")
def traced():
    """A JAX-traced preemption-heavy run (gang-heavy, lrtp, 16 nodes,
    seed 3): the ring, the stream in both schemas and the job flags."""
    cfg = jcluster.SimConfig(cluster=jcluster.ClusterSpec(n_nodes=N_NODES),
                             workload=jcluster.WorkloadSpec(n_jobs=96),
                             policy="lrtp", seed=3)
    js = jscenarios.build("gang-heavy", cfg)
    st = sim_jax.run_jit(cfg, sim_jax.jobs_from_jobset(js), 3, trace=True)
    jev, overflow = sim_jax.decode_trace(st)
    assert overflow == 0
    tev = [tschema.Event(*e.as_tuple()) for e in jev]
    return dict(buf=np.array(st.ev_buf), n=int(st.ev_n), jev=jev,
                tev=tev, is_te=np.asarray(js.is_te))


def both(events):
    """The same (t, code, job, aux, nodes) rows as events of each
    package."""
    return ([jschema.Event(*e) for e in events],
            [tschema.Event(*e) for e in events])


def test_schema_constants_match():
    assert tschema.EVENT_NAMES == jschema.EVENT_NAMES
    assert tschema.PLACEMENT_CODES == jschema.PLACEMENT_CODES
    assert tschema.RELEASE_CODES == jschema.RELEASE_CODES
    for name in jschema.EVENT_NAMES:
        assert getattr(tschema, name) == getattr(jschema, name)
        assert getattr(tobs, name) == getattr(jschema, name)


# the cases of tests/test_obs.py's schema validation, plus a valid one
VALIDATE_CASES = [
    [(0, jschema.START, 0, -1, (0,))],
    [(0, jschema.SUBMIT, 0, -1, ()), (0, jschema.SUBMIT, 0, -1, ())],
    [(0, jschema.SUBMIT, 0, -1, ()), (0, jschema.START, 0, -1, ())],
    [(1, jschema.SUBMIT, 0, -1, ()), (0, jschema.SUBMIT, 1, -1, ())],
    [(0, jschema.SUBMIT, 0, -1, ()), (0, jschema.RESUME, 0, -1, (0,))],
    [(0, jschema.SUBMIT, 0, -1, ()), (0, jschema.VACATE, 0, -1, ())],
    [(0, jschema.SUBMIT, 0, -1, ()), (0, jschema.START, 0, -1, (0,)),
     (1, jschema.FINISH, 0, -1, ()), (2, jschema.REQUEUE, 0, -1, ())],
    [(0, 99, 0, -1, ())],
    [(0, jschema.SUBMIT, 0, -1, ()), (0, jschema.START, 0, -1, (0,)),
     (3, jschema.VACATE, 0, -1, ())],
    [(0, jschema.SUBMIT, 0, -1, ()), (0, jschema.START, 0, -1, (0, 5)),
     (1, jschema.PREEMPT_SIGNAL, 0, 7, ()), (3, jschema.GRACE_EXPIRE, 0,
                                             -1, ()),
     (3, jschema.VACATE, 0, 7, ()), (3, jschema.REQUEUE, 0, -1, ()),
     (4, jschema.RESUME, 0, -1, (2,)), (4, jschema.BACKFILL, 0, 3, ()),
     (9, jschema.FINISH, 0, -1, ())],
]


def _verdict(validate, events, **kw):
    try:
        validate(events, **kw)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", range(len(VALIDATE_CASES)))
def test_validate_events_same_verdict(case):
    jev, tev = both(VALIDATE_CASES[case])
    for kw in ({}, {"n_jobs": 1, "n_nodes": 4}):
        want = _verdict(jschema.validate_events, jev, **kw)
        assert _verdict(tschema.validate_events, tev, **kw) == want
    assert [e.render() for e in tev] == [e.render() for e in jev]
    assert [e.name for e in tev] == [e.name for e in jev]


def test_validate_real_trace_and_render(traced):
    tschema.validate_events(traced["tev"], n_jobs=96, n_nodes=N_NODES)
    assert [e.render() for e in traced["tev"]] == \
        [e.render() for e in traced["jev"]]
    for j in (0, 5, 17):
        assert [e.as_tuple() for e in tschema.events_of_job(
            traced["tev"], j)] == [e.as_tuple() for e in
                                   jschema.events_of_job(traced["jev"], j)]
    for ev in (PreemptionEvent(3, 7, 10), PreemptionEvent(3, 7, 10, 12),
               PreemptionEvent(3, 7, 10, 12, 15)):
        assert tschema.render_preemption(ev) == \
            jschema.render_preemption(ev)


@pytest.mark.parametrize("n_nodes", [1, 8, 31, 32, 33, 84, 200])
def test_ring_layout_helpers_match(n_nodes):
    assert tring.HEADER_WORDS == jring.HEADER_WORDS
    assert tring.NODE_WORD_BITS == jring.NODE_WORD_BITS
    assert tring.n_node_words(n_nodes) == jring.n_node_words(n_nodes)
    w = tring.node_mask_weights(n_nodes)
    assert w.dtype == np.uint32
    np.testing.assert_array_equal(w, jring.node_mask_weights(n_nodes))
    for n_jobs, P in ((96, 1), (2 ** 16, 1), (1000, 4), (7, 0)):
        assert tring.default_capacity(n_jobs, P) == \
            jring.default_capacity(n_jobs, P)
        assert tring.round_capacity(n_jobs, P) == \
            jring.round_capacity(n_jobs, P)


def test_decode_ring_numpy_and_torch(traced):
    buf, n = traced["buf"], traced["n"]
    want, w_over = jring.decode_ring(buf, n)
    for b, k in ((buf, n), (torch.from_numpy(buf), n),
                 (torch.from_numpy(buf), torch.tensor(n, dtype=torch.int32))):
        got, over = tring.decode_ring(b, k)
        assert over == w_over == 0
        assert [e.as_tuple() for e in got] == [e.as_tuple() for e in want]
        assert all(type(e) is tschema.Event for e in got)
    # a truncated ring: the same overflow count and prefix
    got, over = tring.decode_ring(torch.from_numpy(buf[:33].copy()), n)
    want, w_over = jring.decode_ring(buf[:33], n)
    assert over == w_over == n - 32 > 0
    assert [e.as_tuple() for e in got] == [e.as_tuple() for e in want]


def test_decode_ring_packs_many_nodes():
    """Placement rows over three node words, bit 31 of a word set (a
    negative int32) included."""
    n_nodes = 70
    rng = np.random.default_rng(0)
    masks = rng.random((5, n_nodes)) < 0.3
    masks[0, 31] = masks[1, 63] = True
    packed = (masks[:, None, :] * jring.node_mask_weights(n_nodes)[None]) \
        .sum(2, dtype=np.uint32).view(np.int32)
    buf = np.zeros((9, 4 + packed.shape[1]), np.int32)
    buf[:5, 0] = np.arange(5)
    buf[:5, 1] = jschema.START
    buf[:5, 2] = np.arange(5)
    buf[:5, 3] = -1
    buf[:5, 4:] = packed
    got, _ = tring.decode_ring(torch.from_numpy(buf), 5)
    want, _ = jring.decode_ring(buf, 5)
    assert [e.as_tuple() for e in got] == [e.as_tuple() for e in want]
    assert [e.nodes for e in got] == \
        [tuple(np.flatnonzero(m)) for m in masks]


def test_csv_text_equal_and_round_trip(traced):
    text = texport.to_csv(traced["tev"])
    assert text == jexport.to_csv(traced["jev"])
    back = texport.read_csv(text)
    assert back == traced["tev"]
    assert texport.CSV_FIELDS == jexport.CSV_FIELDS
    with pytest.raises(ValueError, match="not a trace CSV"):
        texport.read_csv("a,b,c\n1,2,3\n")


@pytest.mark.parametrize("preemptive", [True, False])
def test_perfetto_json_equal(traced, preemptive):
    kw = dict(n_nodes=N_NODES, is_te=traced["is_te"], preemptive=preemptive)
    got = texport.to_perfetto(traced["tev"], **kw)
    want = jexport.to_perfetto(traced["jev"], **kw)
    assert json.dumps(got) == json.dumps(want)
    assert texport.to_perfetto(traced["tev"][:40]) == \
        jexport.to_perfetto(traced["jev"][:40])


def test_trace_files_and_writer_equal(traced, tmp_path):
    for fmt in ("perfetto", "csv"):
        a, b = tmp_path / f"j.{fmt}", tmp_path / f"t.{fmt}"
        jexport.write_trace(str(a), traced["jev"], fmt=fmt,
                            n_nodes=N_NODES, is_te=traced["is_te"])
        texport.write_trace(str(b), traced["tev"], fmt=fmt,
                            n_nodes=N_NODES, is_te=traced["is_te"])
        assert a.read_bytes() == b.read_bytes()
    with pytest.raises(ValueError, match="unknown trace format"):
        texport.write_trace(str(tmp_path / "x"), traced["tev"], fmt="pdf")
    a, b = tmp_path / "jw.csv", tmp_path / "tw.csv"
    with jexport.CsvTraceWriter(str(a)) as jw, \
            texport.CsvTraceWriter(str(b)) as tw:
        for lo in range(0, len(traced["jev"]), 100):
            jw.write(traced["jev"][lo:lo + 100])
            tw.write(traced["tev"][lo:lo + 100])
        assert tw.n_written == jw.n_written == len(traced["tev"])
    assert a.read_bytes() == b.read_bytes()
    assert texport.read_csv(b.read_text()) == traced["tev"]


@pytest.mark.parametrize("preemptive", [True, False])
def test_timeseries_equal(traced, preemptive):
    got = tts.compute_timeseries(traced["tev"], N_NODES,
                                 is_te=traced["is_te"],
                                 preemptive=preemptive)
    want = jts.compute_timeseries(traced["jev"], N_NODES,
                                  is_te=traced["is_te"],
                                  preemptive=preemptive)
    for f in dataclasses.fields(jts.TimeSeries):
        x, y = getattr(got, f.name), getattr(want, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name
    assert got.makespan == want.makespan
    assert got.preempt_rate == want.preempt_rate
    assert got.mean_utilization() == want.mean_utilization()
    for rows in (5, 20, 10_000):
        assert tts.format_timeseries(got, rows) == \
            jts.format_timeseries(want, rows)


def test_slowdown_decomposition_equal(traced):
    got = tts.slowdown_decomposition(traced["tev"])
    want = jts.slowdown_decomposition(traced["jev"])
    assert sorted(got) == sorted(want) == list(range(96))
    for j in want:
        assert dataclasses.astuple(got[j]) == dataclasses.astuple(want[j])
        assert got[j].identity_holds() and want[j].identity_holds()
        assert got[j].turnaround == want[j].turnaround
    # a prefix leaves jobs unfinished: the same partial records
    cut = len(traced["tev"]) // 2
    got = tts.slowdown_decomposition(traced["tev"][:cut])
    want = jts.slowdown_decomposition(traced["jev"][:cut])
    assert {j: dataclasses.astuple(d) for j, d in got.items()} == \
        {j: dataclasses.astuple(d) for j, d in want.items()}
    assert any(d.finish == -1 for d in got.values())

"""Slowdown-rate metrics, paper-table summarization and the parity
helpers of the reference engine (host numpy; the port's copy of the
JAX package's ``core/metrics.py``)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.core.types import SimResult
from repro_torch.obs import schema as obs_schema


def assert_result_parity(a: SimResult, b: SimResult) -> None:
    """Bit-exactness check between two SimResults: per-job finish
    ticks, preemption counts and inputs, the makespan, the
    ``PreemptionEvent`` stream and, when both runs were traced, the
    event trace. A preemption-stream divergence is reported as the
    FIRST diverging event index with both sides rendered in the
    canonical event vocabulary (``obs.schema``)."""
    np.testing.assert_array_equal(a.finish, b.finish)
    np.testing.assert_array_equal(a.preempt_count, b.preempt_count)
    np.testing.assert_array_equal(a.submit, b.submit)
    np.testing.assert_array_equal(a.exec_total, b.exec_total)
    np.testing.assert_array_equal(a.is_te, b.is_te)
    assert a.makespan == b.makespan, (a.makespan, b.makespan)
    for i, (ea, eb) in enumerate(zip(a.events, b.events)):
        if ea.as_tuple() != eb.as_tuple():
            raise AssertionError(
                f"preemption streams diverge at event {i}:\n"
                f"  a: {obs_schema.render_preemption(ea)}\n"
                f"  b: {obs_schema.render_preemption(eb)}")
    assert len(a.events) == len(b.events), \
        (f"preemption stream lengths differ: "
         f"{len(a.events)} vs {len(b.events)}")
    if a.trace is not None and b.trace is not None:
        assert_trace_parity(a.trace, b.trace)


def assert_trace_parity(a: Sequence, b: Sequence) -> None:
    """Exact equality of two canonical event streams
    (``obs.schema.Event`` lists: a traced reference run against a
    decoded ring, or the two time modes of one engine). On divergence,
    reports the first differing index with both events rendered."""
    for i, (ea, eb) in enumerate(zip(a, b)):
        if ea.as_tuple() != eb.as_tuple():
            raise AssertionError(
                f"traces diverge at event {i}:\n"
                f"  a: {ea.render()}\n  b: {eb.render()}")
    assert len(a) == len(b), \
        f"trace lengths differ: {len(a)} vs {len(b)}"


def sim_throughput(res: SimResult, seconds: float) -> float:
    """Jobs simulated per wall-clock second (engine benchmarks)."""
    return len(res.finish) / max(seconds, 1e-12)


def percentiles(x: np.ndarray, ps=(50, 95, 99)) -> Dict[str, float]:
    if len(x) == 0:
        return {f"p{p}": float("nan") for p in ps}
    return {f"p{p}": float(np.percentile(x, p)) for p in ps}


def slowdown_table(res: SimResult) -> Dict[str, Dict[str, float]]:
    """Table 1 / Table 5 row: slowdown percentiles for TE and BE (any
    object with ``slowdown`` and ``is_te``)."""
    sd = res.slowdown
    return {"TE": percentiles(sd[res.is_te]),
            "BE": percentiles(sd[~res.is_te])}


def resched_table(res: SimResult) -> Dict[str, float]:
    """Table 2 row: re-scheduling interval percentiles [min]."""
    return percentiles(res.resched_intervals, ps=(50, 75, 95, 99))


def pooled_tables(pool: Dict[str, np.ndarray]) -> Dict:
    """Tables over per-job stats pooled across workloads (keys
    ``slowdown``, ``is_te``, ``preempt_count``, ``intervals``). Empty
    classes yield explicit ``nan`` entries."""
    sd, te = pool["slowdown"], pool["is_te"]
    pc = pool["preempt_count"][~te]
    n_be = len(pc) if len(pc) else float("nan")
    return {
        "TE": percentiles(sd[te]),
        "BE": percentiles(sd[~te]),
        "intervals": percentiles(pool["intervals"], ps=(50, 75, 95, 99)),
        "preempted_frac": float((pc > 0).mean()) if len(pc)
        else float("nan"),
        "preempt_counts": {
            "1": float((pc == 1).sum()) / n_be,
            "2": float((pc == 2).sum()) / n_be,
            ">=3": float((pc >= 3).sum()) / n_be,
        },
    }

"""Slowdown-rate metrics and paper-table summarization (host numpy)."""
from __future__ import annotations

from typing import Dict

import numpy as np


def percentiles(x: np.ndarray, ps=(50, 95, 99)) -> Dict[str, float]:
    if len(x) == 0:
        return {f"p{p}": float("nan") for p in ps}
    return {f"p{p}": float(np.percentile(x, p)) for p in ps}


def slowdown_table(slowdown: np.ndarray,
                   is_te: np.ndarray) -> Dict[str, Dict[str, float]]:
    """Table 1 / Table 5 row: slowdown percentiles for TE and BE."""
    return {"TE": percentiles(slowdown[is_te]),
            "BE": percentiles(slowdown[~is_te])}


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

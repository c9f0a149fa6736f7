"""Replay public GPU-cluster traces through the FitGpp policies,
with the §8 telemetry pipeline on top.

The paper validated FitGpp on a private PFN trace; this example replays
public-format traces (Microsoft-Philly-style / Alibaba-PAI-style CSV)
through every policy instead, using the port's copies of the bundled
sample fixtures by default; point ``--philly`` / ``--pai`` at a real
trace export to reproduce at scale (``--time-scale`` compresses a
months-long trace into a tractable horizon).

Alongside the slowdown tables, the FitGpp run is traced through the
canonical event stream (``obs.schema``): the example prints the
replayed utilization / queue-depth time series, the per-job slowdown
decomposition summary (initial wait / grace stall / requeue wait /
service, the identity that makes Eq. 5 auditable), and ``--trace``
writes the stream as a Perfetto JSON or CSV.

Run:  PYTHONPATH=src python -m repro_torch.examples.trace_replay
      ... --philly my_philly.csv --time-scale 60 --nodes 84
      ... --trace pai.perfetto.json
      ... --device cpu

Every run goes through the PyTorch engine, traced through its event
ring, on ``--device`` (the current CUDA device by default; it raises
without one). ``replay(..., engine="reference")`` runs the host numpy
engine instead, as the JAX example does.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch import api
from repro_torch import device as _device
from repro_torch import scenarios
from repro_torch.configs.cluster import ClusterSpec, SimConfig
from repro_torch.core import metrics
from repro_torch.obs import export, timeseries

POLICIES = ("fifo", "lrtp", "rand", "fitgpp")


def telemetry(label: str, js, cfg, events, trace_path,
              trace_format) -> list:
    """Time-series + decomposition view of one traced run's events."""
    ts = timeseries.compute_timeseries(
        events, n_nodes=cfg.cluster.n_nodes, is_te=js.is_te)
    lines = [f"\n{label} fitgpp telemetry: mean utilization "
             f"{ts.mean_utilization() * 100:.1f}%, "
             f"{ts.preempt_rate:.3f} preemptions/min over "
             f"{ts.makespan} min",
             timeseries.format_timeseries(ts, max_rows=12)]
    dec = timeseries.slowdown_decomposition(events)
    parts = np.array([[d.initial_wait, d.grace_stall, d.requeue_wait,
                       d.service] for d in dec.values()], dtype=float)
    if not all(d.identity_holds() for d in dec.values()):
        raise AssertionError("the slowdown decomposition's identity "
                             "fails for a job")
    names = ("initial wait", "grace stall", "requeue wait", "service")
    total = parts.sum()
    lines.append("turnaround decomposition (summed over jobs, identity "
                 "wait+stall+requeue+service == finish-submit holds per "
                 "job):")
    for name, col in zip(names, parts.sum(axis=0)):
        lines.append(f"  {name:13s} {int(col):7d} min "
                     f"({col / total * 100:5.1f}%)")
    if trace_path:
        export.write_trace(trace_path, events, fmt=trace_format,
                           n_nodes=cfg.cluster.n_nodes,
                           is_te=np.asarray(js.is_te))
        lines.append(f"{len(events)} events -> {trace_path} "
                     f"[{trace_format}]")
    return lines


def replay(label: str, loader, path, cfg, time_scale, engine="torch",
           device=None, trace_path=None, trace_format="perfetto") -> tuple:
    """-> (the printed lines, policy -> slowdown table)."""
    js, stats = loader(path, cfg, time_scale=time_scale,
                       return_stats=True)
    gangs = int((np.asarray(js.n_nodes) > 1).sum())
    lines = [f"\n=== {label}: {stats.n_jobs}/{stats.n_rows} rows kept "
             f"({stats.n_malformed} malformed, {stats.n_zero_runtime} "
             f"zero-runtime, {stats.n_too_wide} too wide) — "
             f"{int(js.is_te.sum())} TE, {gangs} gangs, "
             f"horizon {int(js.submit.max())} min ==="]
    rows, traced = {}, None
    for pol in POLICIES:
        r = api.run_experiment(cfg=dataclasses.replace(cfg, policy=pol),
                               jobs=js, engine=engine, trace=True,
                               device=device)
        if r.trace_overflow:
            raise RuntimeError(f"{label} {pol}: the event ring dropped "
                               f"{r.trace_overflow} rows")
        rows[pol] = r.table
        if pol == "fitgpp":
            traced = r.events
    lines.append(metrics.format_table(rows, "slowdown percentiles"))
    lines += telemetry(label, js, cfg, traced, trace_path, trace_format)
    return lines, rows


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--philly", default=scenarios.traces.PHILLY_SAMPLE,
                    help="Philly-style CSV (default: bundled fixture)")
    ap.add_argument("--pai", default=scenarios.traces.PAI_SAMPLE,
                    help="PAI-style CSV (default: bundled fixture)")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--time-scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write the PAI replay's fitgpp event stream "
                         "to PATH")
    ap.add_argument("--trace-format", default="perfetto",
                    choices=("perfetto", "csv"))
    ap.add_argument("--device", default=None,
                    help="the engine's device (default: the current CUDA "
                         "device)")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)

    cfg = SimConfig(cluster=ClusterSpec(n_nodes=args.nodes),
                    seed=args.seed)
    lines, _ = replay("Philly-style", scenarios.load_philly_csv,
                      args.philly, cfg, args.time_scale, device=device)
    pai, _ = replay("PAI-style", scenarios.load_pai_csv, args.pai, cfg,
                    args.time_scale, device=device, trace_path=args.trace,
                    trace_format=args.trace_format)
    lines += pai
    lines.append("\nTE/BE split: runtime <= 30 min is TE (paper §4.2 "
                 "truncation);\ngrace periods are sampled from the cfg GP "
                 "distribution (traces record none).")
    text = "\n".join(lines)
    print(text)
    return text


if __name__ == "__main__":
    main()

"""Bounded-memory replay of a long trace through the streaming
macro-round engine (DESIGN.md §10).

The monolithic engines hold every job of a workload in memory; this
example replays an arbitrarily long stream through
``core.stream.StreamEngine`` instead: a fixed pool of ``--capacity``
slots recycled as jobs finish, fed chunk by chunk from a ``JobSource``,
with per-round event/result draining. Memory scales with the pool, not
the trace: the peak RSS and peak device GB printed at the end are flat
in ``--n-jobs``.

Three source flavors, all submit-ordered chunk iterators:

* ``synthetic``: ``workload.stream_chunks``, the open-loop chunked
  generator (default; scale ``--n-jobs`` freely, 10^5+ is fine);
* ``philly`` / ``pai``: a bundled sample fixture tiled end-to-end to
  ``--n-jobs`` (``scenarios.traces.tiled_source``), or point ``--csv``
  at a real Philly/PAI-style export to stream it row by row without
  ever materializing the full trace.

``--trace out.csv`` attaches an incremental ``CsvTraceWriter`` sink:
the canonical event stream lands on disk round by round in O(batch)
memory. ``--parity`` first checks the bit-parity window (streamed ==
monolithic on a small prefix, random draws included) before the long
replay.

Run:  PYTHONPATH=src python -m repro_torch.examples.stream_replay
      ... --n-jobs 100000 --capacity 2048 --parity
      ... --source philly --n-jobs 5000 --trace stream.csv
      ... --device cpu

The engine runs on ``--device`` (the current CUDA device by default; it
raises without one); its fused schedule pass is the CUDA kernel there.
"""
from __future__ import annotations

import argparse
import dataclasses
import resource
import time

import torch

from repro_torch import api
from repro_torch import device as _device
from repro_torch.configs.cluster import ClusterSpec, SimConfig, WorkloadSpec
from repro_torch.core import metrics, stream, workload
from repro_torch.obs import export
from repro_torch.scenarios import traces


def make_source(args, cfg):
    if args.source == "synthetic":
        return stream.JobSource(
            workload.stream_chunks(cfg, args.n_jobs, chunk=args.chunk))
    dialect = args.source
    path = args.csv or {"philly": traces.PHILLY_SAMPLE,
                        "pai": traces.PAI_SAMPLE}[dialect]
    if args.csv:
        # a real export: one streaming pass, never materialized
        return traces.trace_source(path, cfg, dialect, chunk=args.chunk)
    # bundled ~26-job fixture: tile it end-to-end up to n_jobs
    return traces.tiled_source(path, cfg, dialect)


def main(argv=None, *, parity_jobs: int = 400,
         parity_capacity: int = 96) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default="synthetic",
                    choices=("synthetic", "philly", "pai"))
    ap.add_argument("--csv", default=None,
                    help="real trace CSV to stream (with --source "
                         "philly|pai); default: tiled bundled fixture")
    ap.add_argument("--policy", default="fitgpp",
                    choices=api.policy_names())
    ap.add_argument("--n-jobs", type=int, default=20000)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=None,
                    help="slot-pool size (default 32 x nodes x P)")
    ap.add_argument("--load", type=float, default=0.5,
                    help="open-loop load for the synthetic stream "
                         "(keep < ~0.9: the backlog must fit the pool)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="stream the canonical event CSV to PATH "
                         "round by round (incremental sink)")
    ap.add_argument("--parity", action="store_true",
                    help="check the bit-parity window (streamed == "
                         "monolithic prefix) before replaying")
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    cfg = SimConfig(cluster=ClusterSpec(n_nodes=args.nodes),
                    workload=WorkloadSpec(n_jobs=args.n_jobs),
                    policy=args.policy, seed=args.seed)
    cfg = dataclasses.replace(
        cfg, workload=dataclasses.replace(cfg.workload, load=args.load))
    lines = []
    if args.parity:
        diff = stream.verify_prefix_parity(cfg, n_jobs=parity_jobs,
                                           capacity=parity_capacity,
                                           chunk=64, device=dev)
        if diff:
            raise AssertionError(f"parity window diverged in {diff}")
        lines.append(f"parity window ok: {parity_jobs}-job streamed prefix "
                     "bit-identical to the monolithic engine")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sink = export.CsvTraceWriter(args.trace) if args.trace else None
    eng = stream.StreamEngine(cfg, make_source(args, cfg),
                              capacity=args.capacity,
                              trace=sink is not None,
                              event_sink=sink.write if sink else None,
                              device=dev)
    t0 = time.perf_counter()
    res = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if sink:
        sink.close()
        lines.append(f"{sink.n_written} events -> {args.trace} "
                     f"(incremental, overflow={res.trace_overflow})")

    lines.append(f"\n{res.n_jobs} jobs through {res.capacity} slots in "
                 f"{res.rounds} rounds (peak live {res.max_live}) — "
                 f"{dt:.1f}s, {res.n_jobs / dt:.0f} jobs/s")
    s = res.summary()
    lines.append(metrics.format_table(
        {args.policy: {"TE": s["TE"], "BE": s["BE"]}},
        f"slowdown percentiles (makespan {res.makespan} min)"))
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    gb = (f"{torch.cuda.max_memory_allocated(dev) / 1e9:.4f} GB"
          if dev.type == "cuda" else "none (CPU run)")
    lines.append(f"peak RSS {rss:.0f} MB, peak device {gb} — rerun with a "
                 "different --n-jobs at the same --capacity to see them "
                 "stay flat")
    text = "\n".join(lines)
    print(text)
    return text


if __name__ == "__main__":
    main()

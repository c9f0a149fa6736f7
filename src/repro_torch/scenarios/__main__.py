"""Scenario runner CLI (the port's ``python -m repro.scenarios``).

    PYTHONPATH=src python -m repro_torch.scenarios list
        [--kind synthetic|trace]
    PYTHONPATH=src python -m repro_torch.scenarios describe NAME
        [--n-jobs 512]
    PYTHONPATH=src python -m repro_torch.scenarios run NAME
        [--policy fitgpp] [--engine torch|reference] [--device cuda|cpu]
        [--n-jobs 512] [--nodes 16] [--seed 0] [--mode event|tick]
        [--trace out.json [--trace-format perfetto|csv]]
        [--stream [--capacity N] [--closed-loop]]
    PYTHONPATH=src python -m repro_torch.scenarios sweep NAME [NAME ...]
        [--seeds 0,1] [--n-jobs 256] [--policy fitgpp] [--device cuda|cpu]
        [--mode event|tick] [--devices N] [--mesh auto|off]

``run`` replays one scenario through ``repro_torch.api.run_experiment``
on either engine (any policy of the port's table) and prints the
paper-style slowdown table; ``--trace`` writes the run's event stream
through ``obs.export``. With ``--stream`` it goes through the stream
engine (``repro_torch.api.run_stream``) instead, whose memory scales
with ``--capacity`` rather than the trace length. ``sweep`` batches
every (scenario, seed) trial, ragged job counts included, into one
batched engine run (``api.scenario_sweep``). ``describe`` adds one-pass
stream statistics (job counts, TE/BE split, the reader's drop counts)
for scenarios with a registered streaming source. The tables are the
JAX CLI's.

``run`` takes the torch engine unless ``--engine reference`` is given
(the facade's default; the JAX CLI defaults to its reference engine).
The torch engine, the stream engine and the sweep run on ``--device``,
the current CUDA device by default (``--device cpu`` runs the plain
PyTorch path); the reference engine runs on the host, and ``--device``
or ``--stream`` with it is refused. ``--score-backend`` is left out: in
the port the tensors' device picks between the CUDA kernel and its
plain version.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import api, scenarios
from repro_torch.configs.cluster import ClusterSpec, SimConfig, WorkloadSpec
from repro_torch.core import metrics


def _cfg(args, seed=None) -> SimConfig:
    return SimConfig(
        cluster=ClusterSpec(n_nodes=args.nodes),
        workload=WorkloadSpec(n_jobs=args.n_jobs),
        policy=args.policy,
        time_mode=getattr(args, "mode", "event"),
        seed=args.seed if seed is None else seed)


def cmd_list(args) -> None:
    rows = scenarios.all_scenarios(args.kind)
    width = max(len(s.name) for s in rows)
    for sc in rows:
        print(f"{sc.name:{width}s}  [{sc.kind}]  {sc.description}")
    n_syn = len(scenarios.scenario_names(scenarios.SYNTHETIC))
    n_tr = len(scenarios.scenario_names(scenarios.TRACE))
    print(f"\n{n_syn} synthetic scenarios, {n_tr} trace adapters")


def cmd_describe(args) -> None:
    sc = scenarios.get_scenario(args.name)
    print(f"{sc.name} [{sc.kind}]\n  {sc.description}")
    lines = (sc.fn.__doc__ or "").strip().splitlines()
    if lines and lines[0].strip() == sc.description:
        lines = lines[1:]                      # summary already printed
    if any(ln.strip() for ln in lines):
        print("\n" + "\n".join(f"  {ln.strip()}" for ln in lines))
    if sc.knobs:
        print("\n  knobs:")
        for k, v in sc.knobs:
            print(f"    {k:28s} {v}")
    if sc.source is not None:
        # one bounded-memory pass over the registered stream: job
        # counts, class split and the reader's drop counts in one read
        from repro_torch.core import stream
        cfg = SimConfig(cluster=ClusterSpec(n_nodes=args.nodes),
                        workload=WorkloadSpec(n_jobs=args.n_jobs),
                        seed=args.seed)
        info = stream.scan(sc.source(cfg))
        print(f"\n  stream (one pass, n_jobs={args.n_jobs}):")
        print(f"    {info.n_jobs} jobs: {info.n_te} TE / {info.n_be} BE, "
              f"{info.n_gang} gangs; horizon {info.horizon} min, "
              f"{info.total_exec_min} exec-min total")
        ts = info.stats
        if ts is not None:
            print(f"    kept {ts.n_jobs}/{ts.n_rows} rows (dropped: "
                  f"{ts.n_malformed} malformed, {ts.n_zero_runtime} "
                  f"zero-runtime, {ts.n_too_wide} too-wide, "
                  f"{ts.n_filtered_status} status-filtered)")


def _write_trace(args, cfg, r, is_te) -> None:
    from repro_torch.obs import export
    export.write_trace(args.trace, r.events, fmt=args.trace_format,
                       n_nodes=cfg.cluster.n_nodes, is_te=is_te,
                       preemptive=api.get_policy(cfg.policy).preemptive)
    print(f"{len(r.events)} events -> {args.trace} [{args.trace_format}]"
          + (f" (WARNING: {r.trace_overflow} rows dropped)"
             if r.trace_overflow else ""))


def _print_result(r) -> None:
    print(metrics.format_table(
        {r.policy: r.table},
        f"slowdown percentiles (makespan {r.makespan} min)"))
    print(f"resched intervals [min]: p50={r.intervals['p50']:.1f} "
          f"p95={r.intervals['p95']:.1f}   preempted "
          f"{r.preempted_frac * 100:.1f}% of BE jobs")


def cmd_stream(args, cfg) -> None:
    r = api.run_stream(args.name, cfg.policy, cfg=cfg,
                       capacity=args.capacity, mode=args.mode,
                       trace=bool(args.trace),
                       admission=(True if args.closed_loop else None),
                       device=args.device)
    res = r.raw
    arrivals = (f"closed-loop (load {cfg.workload.load:g}) "
                if args.closed_loop else "")
    print(f"{args.name}: {res.n_jobs} jobs streamed {arrivals}through "
          f"{res.capacity} slots in {res.rounds} rounds "
          f"(peak live {res.max_live}, spilled {res.n_spilled}), "
          f"policy={cfg.policy}, engine=stream, "
          f"nodes={cfg.cluster.n_nodes}")
    _print_result(r)
    print(f"fallback_count={r.fallback_count} "
          f"trace_overflow={r.trace_overflow}")
    if args.trace:
        _write_trace(args, cfg, r, res.is_te)


def cmd_run(args) -> None:
    cfg = _cfg(args)
    if args.stream:
        cmd_stream(args, cfg)
        return
    js = scenarios.build(args.name, cfg)
    gangs = int((np.asarray(js.n_nodes) > 1).sum())
    print(f"{args.name}: {js.n} jobs ({int(js.is_te.sum())} TE, "
          f"{gangs} gangs), horizon {int(js.submit.max())} min, "
          f"policy={cfg.policy}, engine={args.engine}, "
          f"nodes={cfg.cluster.n_nodes}")
    r = api.run_experiment(args.name, cfg.policy, args.engine, cfg=cfg,
                           jobs=js, mode=args.mode, trace=bool(args.trace),
                           device=args.device)
    _print_result(r)
    if args.engine == "torch":
        print(f"fallback_count={r.fallback_count} "
              f"trace_overflow={r.trace_overflow}")
    if args.trace:
        _write_trace(args, cfg, r, np.asarray(js.is_te))


def cmd_sweep(args) -> None:
    seeds = [int(s) for s in args.seeds.split(",")]
    devices = 1 if args.mesh == "off" else args.devices
    out = api.scenario_sweep(_cfg(args), args.names, seeds,
                             devices=devices, device=args.device)
    # the sweep ran on one device (mesh_for_sweep raises for more)
    n_avail = (1 if args.device is not None
               and torch.device(args.device).type != "cuda"
               else torch.cuda.device_count())
    print(f"ragged sweep: {len(args.names)} scenarios x {len(seeds)} "
          f"seeds, policy={args.policy} (seed-averaged), "
          f"1/{n_avail} devices")
    hdr = f"{'scenario':22s} | {'TE p50':>8s} {'TE p95':>8s} " \
          f"| {'BE p50':>8s} {'BE p95':>8s} | {'preempted':>9s}"
    print(hdr + "\n" + "-" * len(hdr))
    for i, name in enumerate(args.names):
        te = np.nanmean(out["te_slowdown"][i], axis=0)
        be = np.nanmean(out["be_slowdown"][i], axis=0)
        pf = np.nanmean(out["preempted_frac"][i])
        print(f"{name:22s} | {te[0]:8.2f} {te[1]:8.2f} "
              f"| {be[0]:8.2f} {be[1]:8.2f} | {pf * 100:8.1f}%")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.scenarios",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list", help="list registered scenarios")
    p.add_argument("--kind", choices=(scenarios.SYNTHETIC, scenarios.TRACE),
                   default=None)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("describe", help="knobs + doc for one scenario "
                                        "(+ one-pass stream stats when "
                                        "it has a streaming source)")
    p.add_argument("name")
    p.add_argument("--n-jobs", type=int, default=512,
                   help="stream length for the one-pass stats (512)")
    p.add_argument("--nodes", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_describe)

    def sim_args(p):
        p.add_argument("--policy", default="fitgpp",
                       choices=api.policy_names())
        p.add_argument("--n-jobs", type=int, default=512)
        p.add_argument("--nodes", type=int, default=16)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device", default=None,
                       help="torch device of the torch engine and the "
                            "sweep (default: the current CUDA device; "
                            "'cpu' runs the plain PyTorch path; refused "
                            "with --engine reference, which runs on the "
                            "host)")

    p = sub.add_parser("run", help="replay through either engine "
                                   "(repro_torch.api.run_experiment)")
    p.add_argument("name")
    sim_args(p)
    p.add_argument("--engine", default="torch", choices=api.ENGINES)
    p.add_argument("--mode", default="event", choices=("event", "tick"),
                   help="time advancement, either engine (bit-identical; "
                        "event skips no-op ticks)")
    p.add_argument("--trace", metavar="PATH", default=None,
                   help="record the canonical event stream (both "
                        "engines; the State's ring on torch) and write "
                        "it to PATH")
    p.add_argument("--trace-format", default="perfetto",
                   choices=("perfetto", "csv"),
                   help="trace file format: Chrome/Perfetto JSON "
                        "(load in ui.perfetto.dev) or lossless CSV")
    p.add_argument("--stream", action="store_true",
                   help="replay through the bounded-memory stream engine "
                        "(core/stream) on --device: memory scales with "
                        "--capacity, not --n-jobs")
    p.add_argument("--capacity", type=int, default=None,
                   help="stream engine slot-pool size (default "
                        "32 x nodes x max_preemptions)")
    p.add_argument("--closed-loop", action="store_true",
                   help="with --stream: re-stamp the source's submit "
                        "times as closed-loop admit ticks holding the "
                        "FIFO backlog at the workload load (paper "
                        "§4.2; bit-exact with the monolithic "
                        "closed-loop scenarios)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("sweep", help="ragged multi-scenario batched sweep")
    p.add_argument("names", nargs="+")
    sim_args(p)
    p.add_argument("--seeds", default="0,1")
    p.add_argument("--mode", default="event", choices=("event", "tick"),
                   help="time advancement inside the batched sweep "
                        "(per-lane event jumps)")
    p.add_argument("--devices", type=int, default=None,
                   help="cap the sweep at N devices (default: every "
                        "device present; more than one is not ported "
                        "and raises; loud fallback when fewer are "
                        "present)")
    p.add_argument("--mesh", default="auto", choices=("auto", "off"),
                   help="'off' forces the single-device sweep")
    p.set_defaults(fn=cmd_sweep)

    args = ap.parse_args(argv)
    if args.cmd == "run" and args.engine == "reference":
        if args.device is not None:
            ap.error("--device is the torch engine's; the reference "
                     "engine runs on the host")
        if args.stream:
            ap.error("--stream runs the stream engine on the torch "
                     "engine; it does not take --engine reference")
    args.fn(args)


if __name__ == "__main__":
    main()

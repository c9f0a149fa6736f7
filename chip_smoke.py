#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the FitGpp engine on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card, holds
the engine's kernel path against its plain path, and runs the paper's
FIFO-vs-FitGpp comparison at the paper's scale (84 nodes, 2**16 jobs)
through ``repro_torch.api.compare_policies``. Prints one JSON line per
phase, then a ``{"kernels": [...]}`` line, the card's name and power
limit as ``nvidia-smi`` reports them, and last
``{"ok": true, "device": {...}}``. Exits non-zero, before printing any
result, when a phase fails or no CUDA device is present. Imports no JAX
and nothing of the JAX package.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PAPER_JOBS = 2 ** 16
PAPER_NODES = 84
ENGINE_JOBS = 4096
TIMING_REPS = 30
# spin cycles that keep the card busy while the host queues the timed
# calls (about 0.1 s on an H100), so no host latency falls inside them
QUEUE_SPIN_CYCLES = 200_000_000
# H100 SXM (NVIDIA data sheet): HBM3 bandwidth and float32 rate
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
KERNEL_SHAPES = [(b, j, m) for b in (1, 4) for j in (5, 1000, 65536)
                 for m in (8, 84)]


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rand_instance(np, J, M, seed):
    """Integer tiles like the JAX suite's ``_rand_instance``: single
    and 2-node-gang assignments, mixed masks, random queue keys."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    node = rng.integers(0, M, J)
    gang = rng.random(J) < 0.3
    assign = np.zeros((J, M), bool)
    assign[np.arange(J), node] = True
    assign[np.arange(J)[gang], (node[gang] + 1) % M] = True
    return dict(
        demand=np.stack([rng.integers(1, 33, J), rng.integers(1, 257, J),
                         rng.integers(0, 9, J)], 1).astype(f32),
        gp=rng.integers(0, 21, J).astype(f32),
        width=np.where(gang, 2, 1).astype(np.int32),
        queue_key=(rng.random(J) * 100.0).astype(f32),
        assign=assign,
        free=np.stack([rng.integers(0, 16, M), rng.integers(0, 128, M),
                       rng.integers(0, 5, M)], 1).astype(f32),
        pending_free=np.stack([rng.integers(0, 8, M),
                               rng.integers(0, 64, M),
                               rng.integers(0, 3, M)], 1).astype(f32),
        cand=rng.random(J) < 0.7, under=rng.random(J) < 0.9,
        be_q=rng.random(J) < 0.4,
        te_demand=np.array([4.0, 16.0, 4.0], f32),
        node_cap=np.array([32.0, 256.0, 8.0], f32))


def batched_args(torch, np, B, J, M, seed, empty=False):
    """Stacked (B, ...) kernel arguments on the card, normalizers and
    s included."""
    from repro_torch.kernels import ops
    insts = [rand_instance(np, J, M, seed + b) for b in range(B)]
    if empty:
        for inst in insts:
            for k in ("cand", "under", "be_q"):
                inst[k][:] = False
    args = [torch.stack([torch.as_tensor(i[k]) for i in insts]).cuda()
            for k in insts[0]]
    norms = [ops.normalizers(args[0][b], args[1][b], args[7][b],
                             args[11][b]) for b in range(B)]
    return args + [torch.stack([n[0] for n in norms]),
                   torch.stack([n[1] for n in norms]),
                   torch.full((B,), 4.0, device="cuda")]


def bound_ms(B, J, M, n_assigned):
    """Least time for one pass at this shape: bytes (each input read
    once, each output written once) over HBM bandwidth against float32
    operations over the float32 rate; returns (ms, bound_by)."""
    inputs = B * (J * (12 + 4 + 4 + 4 + M + 3) + M * 24 + 24 + 12)
    outputs = B * (J * (4 + 4 * M + 8) + 16)
    # per (job, node): 6 fit compares; per assigned entry: Eq. 2 slack
    # (3 adds, 3 subtracts, 2 min, 1 max); per job: Eq. 1/3 (12) and
    # the demand - eps row (3); finalize: 3 compares per job
    ops_ = B * (J * M * 6 + J * 18 + M * 3) + n_assigned * 9
    t_bytes = (inputs + outputs) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops_ / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps=TIMING_REPS, queued=True):
    """Median of ``reps`` single-call CUDA-event timings (after warm-up).

    ``queued``: a spin kernel holds the card while the host queues every
    call, so each window holds device time only; otherwise each call
    runs on an idle card and its window includes the host's launch
    latency (the time a caller waits for one call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        if not queued:
            end.synchronize()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def time_kernel_ms(torch, ss, args, reps=TIMING_REPS):
    """Device time of the schedule_step kernels, from the events the
    wrapper records right around its launch (tile kernel, finalize
    kernel), medians over ``reps`` calls queued behind a spin kernel:
    (total, tile, finalize) ms."""
    for _ in range(3):
        ss.schedule_step_cuda(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    events = []
    for _ in range(reps):
        ss.schedule_step_cuda(*args, events=events)
    torch.cuda.synchronize()
    return tuple(statistics.median(x) for x in zip(*(
        (s.elapsed_time(e), s.elapsed_time(m), m.elapsed_time(e))
        for s, m, e in events)))


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build_all()
    ptxas = [line.strip() for r in report.values()
             for line in r["log"].splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"seconds": v["seconds"], "cached": v["cached"]}
                      for k, v in report.items()},
          "ptxas": ptxas})


def phase_kernel(torch, np, shapes=KERNEL_SHAPES):
    """Kernel against plain version, all 8 fields bit-equal."""
    from repro_torch.kernels import schedule_step as ss
    cases = [(b, j, m, False) for b, j, m in shapes] + [(1, 1000, 84, True)]
    max_err = 0.0
    for seed, (B, J, M, empty) in enumerate(cases):
        args = batched_args(torch, np, B, J, M, seed, empty)
        k = ss.schedule_step_cuda(*args)
        p = ss.schedule_step_torch(*args)
        torch.cuda.synchronize()
        for name, x, y in zip(ss.SchedulePass._fields, k, p):
            check(x.dtype == y.dtype and x.shape == y.shape,
                  f"schedule_step {name}: {x.dtype}{tuple(x.shape)} vs "
                  f"{y.dtype}{tuple(y.shape)} at B={B} J={J} M={M}")
            err = float((x.double() - y.double()).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(x, y), f"schedule_step {name} differs from "
                  f"the plain version at B={B} J={J} M={M} (max {err})")
    B, J, M = 1, PAPER_JOBS, PAPER_NODES
    args = batched_args(torch, np, B, J, M, 99)
    ms, tile_ms, finalize_ms = time_kernel_ms(torch, ss, args)
    wrapper_ms = time_ms(torch, lambda: ss.schedule_step_cuda(*args),
                         queued=False)
    plain_ms = time_ms(torch, lambda: ss.schedule_step_torch(*args))
    plain_idle_ms = time_ms(torch, lambda: ss.schedule_step_torch(*args),
                            queued=False)
    bound, bound_by = bound_ms(B, J, M, int(args[4].sum()))
    result = {"name": "schedule_step", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/schedule_step.cu",
              "replaces": "src/repro/kernels/schedule_step.py:233",
              "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
              "tile_ms": tile_ms, "finalize_ms": finalize_ms,
              "wrapper_idle_ms": wrapper_ms, "plain_idle_ms": plain_idle_ms,
              "timed_shape": {"B": B, "J": J, "M": M}}
    emit({"phase": "kernel", "cases": len(cases), "all_equal": True,
          "tolerance": "bit-exact, all 8 fields", **result})
    return result


def phase_engine(torch, n_jobs=ENGINE_JOBS):
    """The engine's kernel path against its plain path on the card (same
    generator seed, full State equal, generator included), and the card
    against the CPU plain path on a small contended input."""
    from repro_torch import api, scenarios
    from repro_torch.core import sim_torch
    from repro_torch.kernels import ops
    cfg = api.make_config("fifo", n_jobs=n_jobs, n_nodes=PAPER_NODES,
                          seed=0)
    jobs = sim_torch.jobs_from_jobset(scenarios.build("paper-synthetic",
                                                      cfg), "cuda")
    for policy in ("fitgpp", "lrtp"):
        pcfg = dataclasses.replace(cfg, policy=policy)
        out = {}
        for path, force in (("kernel", False), ("plain", True)):
            ops._FORCE_PLAIN = force
            try:
                t0 = time.perf_counter()
                st = sim_torch.run(pcfg, jobs, cfg.seed)
                torch.cuda.synchronize()
                out[path] = (sim_torch.state_to_numpy(st),
                             time.perf_counter() - t0)
            finally:
                ops._FORCE_PLAIN = False
        diff = sim_torch.state_diff_fields(out["kernel"][0], out["plain"][0])
        check(not diff, f"{policy}: kernel-path State differs from the "
              f"plain path in {diff}")
        st = out["kernel"][0]
        check(int(st["n_done"]) == n_jobs, f"{policy}: run did not finish")
        emit({"phase": "engine_kernel_vs_plain", "policy": policy,
              "n_jobs": n_jobs, "equal": True,
              "fallback_count": int(st["fallback_count"]),
              "preemptions": int(st["preempt_count"].sum()),
              "kernel_path_s": out["kernel"][1],
              "plain_path_s": out["plain"][1]})
    # small contended input: the card's kernel path against the CPU
    # plain path (no fallback draw fires here, so the two generators
    # never decide anything)
    small = api.make_config("fitgpp", n_jobs=256, n_nodes=8, seed=2, P=2)
    js = scenarios.build("paper-synthetic", small)
    states = [sim_torch.state_to_numpy(sim_torch.run(
        small, sim_torch.jobs_from_jobset(js, dev), 2))
        for dev in ("cuda", "cpu")]
    check(states[0]["fallback_count"] == 0, "small run fell back")
    diff = [f for f in sim_torch.state_diff_fields(*states) if f != "rng"]
    check(not diff, f"card kernel path differs from the CPU plain path "
          f"in {diff}")
    emit({"phase": "engine_card_vs_cpu", "n_jobs": 256, "n_nodes": 8,
          "equal": True, "preemptions": int(states[0]["preempt_count"]
                                              .sum())})


def phase_paper(torch, np, n_jobs=PAPER_JOBS):
    """The main path: api.compare_policies at the paper's scale."""
    from repro_torch import api
    from repro_torch.kernels import ops
    ops.LAUNCHES["schedule_step"] = 0
    ops.KERNEL_EVENTS = []
    try:
        t0 = time.perf_counter()
        rs = api.compare_policies(["fifo", "fitgpp"], n_jobs=n_jobs,
                                  n_nodes=PAPER_NODES, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES["schedule_step"]
        kernel_ms = [(s.elapsed_time(e), s.elapsed_time(m))
                     for s, m, e in ops.KERNEL_EVENTS]
    finally:
        ops.KERNEL_EVENTS = None
    check(launches > 0, "the main path launched no schedule_step kernel")
    per_policy = {}
    k0 = 0
    for policy, r in rs.items():
        st = r.raw.state
        check(st.n_done == n_jobs, f"{policy}: {st.n_done} of {n_jobs} "
              "jobs done")
        check(tuple(st.finish.shape) == (n_jobs,), f"{policy}: bad shape")
        sd = r.table["TE"], r.table["BE"]
        check(all(np.isfinite(v) for t in sd for v in t.values()),
              f"{policy}: non-finite slowdown percentiles")
        k1 = k0 + r.raw.launches
        per_policy[policy] = {
            "wall_s": r.raw.seconds, "iterations": r.raw.iterations,
            "launches": r.raw.launches,
            "kernel_ms": sum(k for k, _ in kernel_ms[k0:k1]),
            "tile_ms": sum(t for _, t in kernel_ms[k0:k1]),
            "TE": r.table["TE"], "BE": r.table["BE"],
            "preempted_frac": r.preempted_frac, "makespan": r.makespan,
            "fallback_count": r.fallback_count}
        k0 = k1
    fifo, fit = rs["fifo"].table, rs["fitgpp"].table
    te_cut = 1.0 - fit["TE"]["p95"] / fifo["TE"]["p95"]
    emit({"phase": "paper_scale", "n_jobs": n_jobs, "n_nodes": PAPER_NODES,
          "wall_s": wall, "launches": launches,
          "kernel_ms_total": sum(k for k, _ in kernel_ms),
          "kernel_events_in_wall": True,
          "te_p95_cut": te_cut,
          "be_p50_worsening": fit["BE"]["p50"] / fifo["BE"]["p50"] - 1.0,
          "be_p95_worsening": fit["BE"]["p95"] / fifo["BE"]["p95"] - 1.0,
          "policies": per_policy})
    check(te_cut >= 0.80, f"TE p95 cut {te_cut:.1%} < 80%")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    t0 = time.perf_counter()
    try:
        phase_build()
        smi = nvidia_smi()
        emit({"phase": "device", "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda})
        kernel = phase_kernel(torch, np)
        phase_engine(torch)
        kernel["launches"] = phase_paper(torch, np)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernel.pop("timed_shape")
    emit({"kernels": [kernel]})
    print(smi)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

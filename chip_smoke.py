#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases build,flash_kernel,...]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all started together), holds each kernel
against its plain PyTorch version on the card, and drives the port's
two main paths through the entry points a user calls:

* the FitGpp engine: the engine's kernel path against its plain path,
  then the paper's FIFO-vs-FitGpp comparison at the paper's scale (84
  nodes, 2**16 jobs) through ``repro_torch.api.compare_policies``;
* dense-LM serving: stablelm-12b at its published widths and full depth
  (40 layers, bf16, random weights from seed 0) prefills 4 prompts of
  2048 tokens through the flash-attention kernel and decodes 32 tokens
  greedily (``repro_torch.launch.serve``); its logits are held against
  the plain path's full forward, then again in float32 at full width
  with 2 layers, and the smoke config's kernel path on the card against
  the CPU plain path.

Each main path runs with every launch count set to 0 just before it and
read just after. Prints one JSON line per phase, then a
``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and last ``{"ok": true, "device": {...}}``.
Exits non-zero, before printing any result, when a phase fails or no
CUDA device is present. With no arguments every phase runs;
``--phases`` runs a subset (for iterating on one part). Imports no JAX
and nothing of the JAX package.
"""
import argparse
import dataclasses
import gc
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
# H100 SXM (NVIDIA data sheet): HBM3 bandwidth, float32 rate outside
# the tensor cores, dense bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
KERNEL_SHAPES = [(b, j, m) for b in (1, 4) for j in (5, 1000, 65536)
                 for m in (8, 84)]
# flash attention: the JAX suite's shapes (tests/test_kernels.py), each
# in f32 and bf16, (B, Sq, Skv, H, KV, hd, causal, window, softcap)
FLASH_SHAPES = [
    (2, 256, 256, 4, 2, 64, True, 0, 0.0),
    (1, 128, 256, 4, 1, 128, True, 0, 0.0),
    (2, 256, 256, 8, 8, 64, True, 64, 0.0),
    (1, 256, 256, 2, 1, 64, False, 0, 0.0),
    (1, 128, 128, 4, 2, 64, True, 0, 30.0),
    (2, 300, 300, 4, 2, 64, True, 0, 0.0),
    (1, 100, 260, 4, 4, 32, True, 48, 0.0),
]
# the stablelm-12b serving prefill: B 4, Sq = Skv 2048, H 32, KV 8, hd 160
SERVE_ARCH = "stablelm-12b"
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 2048, 32
FLASH_MAIN_SHAPE = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 8, 160,
                    True, 0, 0.0)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16, scaled to the output: per row (one query and head), max|delta|
# over max|plain|. The kernel and the plain version round p to bf16 at
# different points (before and after normalising), so a rounded output
# lands a bf16 step or two apart (a step is at most 2^-7 of the row's
# max; on an H100 the serving shape differs by 8.4e-3 of it); a kernel
# wrong by a percent on any row, short or long, fails. The elementwise
# 2e-2 above alone is some 40% of a long row's typical |o| (about 0.05).
FLASH_BF16_ROW_TOL = 1e-2
# Serving agreement, max|logits - reference| over max|reference|.
# bf16: the kernel path and the plain full forward round at different
# points (attention probabilities before/after normalising, matmuls of
# other shapes with other summation orders, so a bf16 result differs by
# a step of 2^-8 here and there), and such steps compound through 40
# residual layers; 2 layers of the smoke config on the CPU already
# differ by 1e-2 from JAX. f32: only the order of sums differs.
SERVE_BF16_TOL = 5e-2
SERVE_F32_TOL = 1e-3
CARD_VS_CPU_TOL = 1e-4


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
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
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


def flash_bound_ms(shape, itemsize):
    """Least time for one flash-attention call: the matrix-product FLOPs
    of the (query, key) pairs this mask attends (2*hd for q.k and 2*hd
    for p.v per pair and head) over the bf16 tensor-core rate, against
    q, k, v read once and o written once over HBM bandwidth."""
    B, Sq, Skv, H, KV, hd, causal, window, _ = shape
    pairs = 0
    for i in range(Sq):
        pos = Skv - Sq + i
        hi = min(Skv - 1, pos) if causal else Skv - 1
        lo = max(0, pos - window + 1) if window > 0 else 0
        pairs += max(0, hi - lo + 1)
    flops = 4 * B * H * hd * pairs
    nbytes = itemsize * hd * (2 * B * Sq * H + 2 * B * Skv * KV)
    t_ops = flops / PEAK_BF16_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_inputs(torch, shape, dtype, seed):
    B, Sq, Skv, H, KV, hd = shape[:6]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))]


def phase_flash_kernel(torch):
    """The flash kernel against its plain version at the JAX suite's 7
    shapes and the serving prefill shape, each in f32 and bf16, then
    timed at the latter beside the plain version and PyTorch's
    scaled_dot_product_attention (a yardstick the port never calls)."""
    from repro_torch.kernels import flash_attention as fa
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    cases = [(s, d) for s in FLASH_SHAPES + [FLASH_MAIN_SHAPE]
             for d in dtypes]
    max_err, max_row_err = {}, 0.0
    for seed, (shape, dname) in enumerate(cases):
        causal, window, cap = shape[6:]
        q, k, v = flash_inputs(torch, shape, dtypes[dname], seed)
        out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      softcap=cap)
        ref = fa.flash_attention_torch(q, k, v, causal=causal,
                                       window=window, softcap=cap)
        torch.cuda.synchronize()
        check(out.dtype == ref.dtype and out.shape == ref.shape,
              f"flash_attention {shape} {dname}: bad output")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        tol = FLASH_TOL[dname]
        check(bool((diff <= tol + tol * ref.float().abs()).all()),
              f"flash_attention differs from the plain version at {shape} "
              f"{dname}: max abs err {err} (tolerance {tol})")
        max_err[dname] = max(max_err.get(dname, 0.0), err)
        if dname == "bfloat16":
            row_err = row_rel_err(out, ref)
            check(row_err <= FLASH_BF16_ROW_TOL, f"flash_attention differs "
                  f"from the plain version at {shape} bf16 by {row_err} of "
                  f"a row's max (tolerance {FLASH_BF16_ROW_TOL})")
            max_row_err = max(max_row_err, row_err)
        del q, k, v, out, ref, diff
    shape = FLASH_MAIN_SHAPE
    q, k, v = flash_inputs(torch, shape, torch.bfloat16, 100)
    ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v))
    plain_ms = time_ms(torch, lambda: fa.flash_attention_torch(q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)

    library_ms = time_ms(torch, sdpa)
    lib_err = float((sdpa().transpose(1, 2).float()
                     - fa.flash_attention_torch(q, k, v).float()).abs().max())
    bound, bound_by = flash_bound_ms(shape, 2)
    result = {"name": "flash_attention", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
              "replaces": "src/repro/kernels/flash_attention.py:123",
              "max_abs_err": max(max_err.values()), "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
              "library_ms": library_ms}
    emit({"phase": "flash_kernel", "cases": len(cases),
          "max_abs_err_by_dtype": max_err, "tolerance": FLASH_TOL,
          "bf16_max_row_rel_err": max_row_err,
          "bf16_row_tolerance": FLASH_BF16_ROW_TOL,
          "timed_shape": dict(zip(("B", "Sq", "Skv", "H", "KV", "hd"),
                                  shape[:6]), dtype="bfloat16", causal=True),
          "library_call": "scaled_dot_product_attention(is_causal=True, "
                          "enable_gqa=True)",
          "library_max_abs_err_vs_plain": lib_err, **result})
    del q, k, v, qt, kt, vt
    return result


# kernel-name fragments of the matrix products (cuBLAS/CUTLASS on Hopper)
MATMUL_KERNELS = ("gemm", "nvjet", "xmma", "cutlass", "cublas", "sm90_")


def device_breakdown(torch, fn):
    """Run ``fn`` once under ``torch.profiler`` and split the device
    time of its kernels by name: matrix products, the flash kernel,
    everything else; ``idle_share`` is 1 - device time / host wall time
    (the profiler's own overhead falls in the wall time). Returns None
    when the profiler shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, n_kernels = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    if not by_name:
        return None
    split = {"matmul_ms": 0.0, "flash_attention_ms": 0.0, "other_ms": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        key = "flash_attention_ms" if "flash_fwd_kernel" in name else \
            "matmul_ms" if any(f in low for f in MATMUL_KERNELS) \
            else "other_ms"
        split[key] += ms
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_kernels": n_kernels, **split,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "top_kernels": [[n[:80], ms] for n, ms in top]}


def reference_logits(torch, cfg, model, prompt, fed):
    """The plain path's full forward (query-chunked attention, no
    kernel) over prompt + fed tokens: logits at the positions the
    serving run produced (the last prompt token, then each fed one)."""
    from repro_torch import models
    from repro_torch.kernels import ops
    tokens = torch.cat([prompt, fed], dim=1)
    ops._FORCE_PLAIN = True
    try:
        logits = models.forward(cfg, model, {"tokens": tokens})
    finally:
        ops._FORCE_PLAIN = False
    return logits[:, prompt.shape[1] - 1:]


def served_logits(torch, res):
    return torch.cat([res.prefill_logits, *res.step_logits], dim=1)


def row_rel_err(got, want):
    """Max over rows (all but the last axis) of max|got - want| over the
    row's max|want|, in float32."""
    d = (got.float() - want.float()).abs().amax(-1)
    return float((d / want.float().abs().amax(-1).clamp_min(1e-30)).max())


def rel_err(torch, got, want):
    """max|got - want| / max|want|, and the mean of |got - want| over
    the mean of |want|, in float32."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    return float(d.max() / w.max()), float(d.mean() / w.mean())


def free_cuda(torch):
    gc.collect()
    torch.cuda.empty_cache()


def layer_attention_errs(torch, cfg, model, prompt):
    """One more prefill in which each layer's flash-kernel output is held
    against the plain ``attend`` on the same q/k/v: the per-row error of
    :func:`row_rel_err`, one per layer. Holds the kernel on inputs from
    the model itself, where the logits cannot see it (the attention
    branch is a small part of the residual stream at this init)."""
    from repro_torch import models
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    attend = attention.attend
    errs = []

    def checking_attend(q, k, v, **kw):
        o = attend(q, k, v, **kw)
        if q.shape[1] > 1:
            ops._FORCE_PLAIN = True
            try:
                errs.append(row_rel_err(o, attend(q, k, v, **kw)))
            finally:
                ops._FORCE_PLAIN = False
        return o

    before = ops.LAUNCHES["flash_attention"]
    attention.attend = checking_attend
    try:
        models.prefill(cfg, model, {"tokens": prompt})
    finally:
        attention.attend = attend
    check(len(errs) == cfg.n_layers and ops.LAUNCHES["flash_attention"]
          - before == cfg.n_layers, "attention not checked once per layer")
    return errs


def phase_serve(torch):
    """The serving main path: stablelm-12b, full config, bf16, random
    weights from seed 0; 4 x 2048-token prefill through the flash
    kernel, 32 greedy decode steps; logits held against the plain
    path's full forward over the same tokens on the same weights, and
    each layer's kernel output against the plain attention on its
    q/k/v."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    model = models.init(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = make_batch(cfg, SERVE_BATCH, SERVE_PROMPT, 0, 0,
                        device="cuda")["tokens"]
    serve.serve(cfg, model, prompt[:, :128], 2)          # warm-up
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    res = serve.serve(cfg, model, prompt, SERVE_STEPS)
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["flash_attention"] == cfg.n_layers,
          f"serving launched flash_attention {launches['flash_attention']} "
          f"times, not once per layer ({cfg.n_layers})")
    check(tuple(res.tokens.shape) == (SERVE_BATCH, SERVE_STEPS + 1),
          "bad token shape")
    got = served_logits(torch, res)
    check(bool(torch.isfinite(got).all()), "non-finite serving logits")
    del res.cache["k"], res.cache["v"]
    free_cuda(torch)
    # where the device time goes: one more prefill, then 4 decode steps,
    # each under the profiler (launch counts are already read)
    state = {}

    def prefill():
        state["logits"], state["cache"] = models.prefill(
            cfg, model, {"tokens": prompt}, pad_to=SERVE_PROMPT + 4)

    def decode():
        tok = state["logits"][:, -1].argmax(-1)[:, None].to(torch.int32)
        for _ in range(4):
            lg, state["cache"] = models.serve_step(cfg, model,
                                                   state["cache"], tok)
            tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)

    profiled = {"prefill": device_breakdown(torch, prefill),
                "decode_4_steps": device_breakdown(torch, decode)}
    state.clear()
    free_cuda(torch)
    attn_errs = layer_attention_errs(torch, cfg, model, prompt)
    free_cuda(torch)
    t0 = time.perf_counter()
    want = reference_logits(torch, cfg, model, prompt,
                            res.tokens[:, :SERVE_STEPS])
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    max_rel, mean_rel = rel_err(torch, got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    emit({"phase": "serve", "arch": SERVE_ARCH, "layers": cfg.n_layers,
          "dtype": cfg.dtype, "params": models.count_params(cfg),
          "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT,
          "decode_steps": SERVE_STEPS, "init_s": init_s,
          "prefill_s": res.prefill_s,
          "decode_ms_per_token": res.decode_s / SERVE_STEPS * 1e3,
          "peak_mem_gb": peak_gb, "launches": launches,
          "logits_max_rel_err": max_rel, "logits_mean_rel_err": mean_rel,
          "tolerance": SERVE_BF16_TOL, "argmax_agreement": agree,
          "attention_max_row_rel_err": max(attn_errs),
          "attention_row_tolerance": FLASH_BF16_ROW_TOL,
          "reference_s": ref_s, "profile": profiled})
    check(max(attn_errs) <= FLASH_BF16_ROW_TOL, f"a layer's flash output "
          f"differs from the plain attention by {max(attn_errs)} of a "
          f"row's max (tolerance {FLASH_BF16_ROW_TOL})")
    check(max_rel <= SERVE_BF16_TOL, f"serving logits differ from the "
          f"plain full forward by {max_rel} of max|logit| "
          f"(tolerance {SERVE_BF16_TOL})")
    del model, got, want
    free_cuda(torch)
    return launches["flash_attention"]


def phase_serve_f32(torch):
    """The tight check: the serving comparison in float32 at full width
    with 2 layers, matmuls in full float32 (TF32 off, and so stated).
    Besides the logits, each layer's attention output (the kernel's
    output during the prefill, the plain path's during the reference)
    is held to the same 1e-3 of its max: a kernel that computed in
    bf16 would miss that by its rounding step alone (2^-9 relative)."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.launch import serve
    from repro_torch.models import attention
    cfg = get_config(SERVE_ARCH).replace(n_layers=2, dtype="float32")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attend = attention.attend
    outs = []

    def recording_attend(q, k, v, **kw):
        o = attend(q, k, v, **kw)
        if q.shape[1] > 1:
            outs.append(o)
        return o

    try:
        model = models.init(cfg, 0, device="cuda")
        prompt = make_batch(cfg, SERVE_BATCH, SERVE_PROMPT, 0, 0,
                            device="cuda")["tokens"]
        attention.attend = recording_attend
        res = serve.serve(cfg, model, prompt, SERVE_STEPS)
        kernel_outs, outs[:] = list(outs), []
        got = served_logits(torch, res)
        del res.cache["k"], res.cache["v"]
        want = reference_logits(torch, cfg, model, prompt,
                                res.tokens[:, :SERVE_STEPS])
    finally:
        attention.attend = attend
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    check(len(kernel_outs) == len(outs) == cfg.n_layers,
          "attention outputs not captured per layer")
    attn_rel = [rel_err(torch, a, b[:, :SERVE_PROMPT])[0]
                for a, b in zip(kernel_outs, outs)]
    max_rel, mean_rel = rel_err(torch, got, want)
    emit({"phase": "serve_f32", "arch": SERVE_ARCH, "layers": cfg.n_layers,
          "dtype": "float32", "allow_tf32": False,
          "logits_max_rel_err": max_rel, "logits_mean_rel_err": mean_rel,
          "attention_max_rel_err": attn_rel, "tolerance": SERVE_F32_TOL})
    check(max_rel <= SERVE_F32_TOL and max(attn_rel) <= SERVE_F32_TOL,
          f"f32 serving differs from the plain path: logits {max_rel}, "
          f"attention {attn_rel} (tolerance {SERVE_F32_TOL})")
    del model, got, want, kernel_outs
    outs.clear()
    free_cuda(torch)


def phase_serve_card_vs_cpu(torch):
    """The smoke config's kernel path on the card against the CPU plain
    path, same weights, same tokens (the card's greedy tokens are fed
    to the CPU run)."""
    from repro_torch import models
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = get_smoke_config(SERVE_ARCH).replace(dtype="float32")
    cpu_model = models.init(cfg, 0, device="cpu")
    card_model = models.init(cfg, 0, device="cpu").to("cuda")
    prompt = make_batch(cfg, 2, 64, 0, 0, device="cpu")["tokens"]
    before = ops.LAUNCHES["flash_attention"]
    res = serve.serve(cfg, card_model, prompt.cuda(), 8)
    check(ops.LAUNCHES["flash_attention"] - before == cfg.n_layers,
          "the card's smoke run did not go through the kernel")
    logits, cache = models.prefill(cfg, cpu_model, {"tokens": prompt},
                                   pad_to=72)
    want = [logits]
    for i in range(8):
        step, cache = models.serve_step(cfg, cpu_model, cache,
                                        res.tokens[:, i:i + 1].cpu())
        want.append(step)
    max_rel, _ = rel_err(torch, served_logits(torch, res).cpu(),
                         torch.cat(want, dim=1))
    emit({"phase": "serve_card_vs_cpu", "arch": cfg.name, "batch": 2,
          "prompt_len": 64, "decode_steps": 8, "logits_max_rel_err": max_rel,
          "tolerance": CARD_VS_CPU_TOL})
    check(max_rel <= CARD_VS_CPU_TOL, f"card kernel path differs from the "
          f"CPU plain path by {max_rel} (tolerance {CARD_VS_CPU_TOL})")


PHASES = ("build", "kernel", "flash_kernel", "engine", "paper", "serve",
          "serve_f32", "serve_card_vs_cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    phases = set(ap.parse_args(argv).phases.split(","))
    unknown = phases - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    t0 = time.perf_counter()
    kernels = []
    try:
        if "build" in phases:
            phase_build()
        smi = nvidia_smi()
        emit({"phase": "device", "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda})
        if "kernel" in phases:
            kernels.append(phase_kernel(torch, np))
        if "flash_kernel" in phases:
            kernels.append(phase_flash_kernel(torch))
        if "engine" in phases:
            phase_engine(torch)
        launches = {}
        if "paper" in phases:
            launches["schedule_step"] = phase_paper(torch, np)
        if "serve" in phases:
            launches["flash_attention"] = phase_serve(torch)
        if "serve_f32" in phases:
            phase_serve_f32(torch)
        if "serve_card_vs_cpu" in phases:
            phase_serve_card_vs_cpu(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for k in kernels:
        k.pop("timed_shape", None)
        k["launches"] = launches.get(k["name"])
    emit({"kernels": kernels})
    print(smi)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

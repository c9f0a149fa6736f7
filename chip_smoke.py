#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases build,flash_kernel,...]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all started together), holds each kernel
against its plain PyTorch version on the card, and drives the port's
two main paths through the entry points a user calls:

* the FitGpp engine: the engine's kernel path against its plain path
  (paper-synthetic, the gang scenarios for every policy, gangs with
  backfill), and the card against the CPU where random draws decide
  (RAND; fitgpp on gang-heavy), then the paper's FIFO-vs-FitGpp
  comparison at the paper's scale (84 nodes, 2**16 jobs) through
  ``repro_torch.api.run_experiment`` on one shared JobSet, then
  gang-heavy on the same 84 nodes (2**12 jobs) under fifo, fitgpp and
  fitgpp with backfill through the same entry point; then the host numpy
  reference engine (``engine="reference"``) on the paper's cell, the
  same-host baseline, held against the torch engine's results; then
  the torch engine traced on the same cell (its event ring; fifo and
  fitgpp at 2**13 jobs), each stream validated, decomposed per
  job and held against the reference engine's stream; then fitgpp on
  phase paper's 2**16 jobs through the stream engine
  (``repro_torch.core.stream.StreamEngine``: a pool of 2,688 job slots,
  closed-loop admission, traced), held against phase paper's run job
  for job and against the reference engine's events job for job;
* the sweep fabric: the batched engine's kernel path against its plain
  path (phase sweep_engine), then Fig. 4 on the paper's 84 nodes
  (fitgpp, five values of s, 4 workloads of 2**14 jobs) as one
  ``repro_torch.core.sweep_fabric.run_table`` on the card, its s = 4
  trials held against the reference engine;
* dense-LM serving: stablelm-12b at its published widths and full depth
  (40 layers, bf16, random weights from seed 0) prefills 4 prompts of
  2048 tokens through the flash-attention kernel and decodes 32 tokens
  greedily (``repro_torch.launch.serve``); its logits are held against
  the plain path's full forward, then again in float32 at full width
  with 2 layers, and the smoke config's kernel path on the card against
  the CPU plain path;
* dense training: stablelm-12b at its published widths with 2 layers
  (bf16, f32 AdamW moments, remat "full") takes 4 steps of 4 x 2048
  tokens through ``repro_torch.launch.train.train`` on attention's
  plain path (no kernel: the flash kernel has no backward, and its
  wrapper refuses an input that requires grad); the state is saved
  after step 2 (``repro_torch.checkpoint``), restored, and steps 3-4
  replayed bit for bit; the same step's dry-run on the meta device
  (``repro_torch.launch.dryrun``, the local mesh) must count the train
  state's bytes exactly, its peak and compute time printed beside the
  measured ones; then the smoke config's steps on the card against the
  CPU's;
* ssm and hybrid training: mamba2-1.3b at its published widths and
  full depth (48 layers, 4 x 2048 tokens; the intra-chunk term by its
  plain version, no kernel) and recurrentgemma-9b at its published
  widths with 3 layers (1 x 4096 tokens; the RG-LRU through the
  lru_scan kernel and its reverse-mode backward, an exact launch count
  a step), 3 steps each; then each smoke config's steps on the card
  against the CPU's;
* moe, vlm and audio training at their published widths, 3 steps each
  on attention's plain path (no kernel): qwen3-moe-30b-a3b at 2 of its
  48 layers (4 x 2048 tokens) and mixtral-8x22b at 1 of its 56 (1 x
  8192, bf16 AdamW moments), each remat recompute's routes held
  against its forward's; internvl2-2b (4 x (256 visual + 1792 text))
  and whisper-large-v3 (4 x (1500 frames + 224 tokens)) at full depth;
* the live controller (``repro_torch.core.controller``): real train
  jobs of the dense smoke config, and the JAX suite's preempt/resume
  case on internvl2-2b's smoke config, preempted by FitGpp, flushed
  and resumed, their losses bit-equal to an uninterrupted run, be0's
  first loss on the card held against the CPU's to a derived bound,
  the JAX suite's two mamba2 smoke cases (TE latency, the
  short-grace-period victim), and every event log equal to the same
  specs' run on the CPU.

Phase sweep_engine also runs a small table as 2 shards in 2 processes
on the card (``repro_torch.sharding.trials``) against one process; the
lru_kernel phase holds the kernel's backward against autograd through
the plain version and reports the route (tma or simple) each case
took, every case bit for bit.

Each main path runs with every launch count set to 0 just before it and
read just after. Prints one JSON line per phase, then a
``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and last ``{"ok": true, "device": {...}}``.
Exits non-zero, before printing any result, when a phase fails or no
CUDA device is present. With no arguments every phase runs;
``--phases`` runs a subset (for iterating on one part) and can name
phase sweep_b1, which the default run leaves out: the sweep engine on
one trial beside the single-trial engine. Imports no JAX and nothing
of the JAX package.
"""
import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.launch import h100  # noqa: E402  (the card's constants)

PAPER_JOBS = 2 ** 16
PAPER_NODES = 84
ENGINE_JOBS = 4096
TIMING_REPS = 30
# spin cycles that keep the card busy while the host queues the timed
# calls (about 0.1 s on an H100), so no host latency falls inside them
QUEUE_SPIN_CYCLES = 200_000_000
# H100 SXM (NVIDIA data sheet, ``repro_torch/launch/h100.py``): HBM3
# bandwidth, float32 rate outside the tensor cores, dense TF32 and bf16
# tensor-core rates
PEAK_BYTES_PER_S = h100.HBM_BYTES_PER_S
PEAK_F32_PER_S = h100.PEAK_F32_FLOPS
PEAK_TF32_PER_S = h100.PEAK_TF32_FLOPS
PEAK_BF16_PER_S = h100.PEAK_BF16_FLOPS
KERNEL_SHAPES = [(b, j, m) for b in (1, 4) for j in (5, 1000, 65536)
                 for m in (8, 84)]
# more tiles than one resident wave of the cooperative grid holds, so
# its blocks walk several tiles each
KERNEL_WIDE_SHAPE = (1, 2 ** 20, 84)
# more nodes than the 640 a tile stages at a time: 7680 and beyond it,
# 12345 being no multiple of 640
KERNEL_NODES_SHAPES = [(1, 1000, 7680), (1, 1024, 8192), (1, 512, 20000),
                       (2, 300, 12345)]
# timed above 640 nodes (also held bit-equal): 4 tiles of jobs, fewer
# than the SMs
KERNEL_MANY_NODES_TIMED = (1, 1024, 8192)
# engine kernel path == plain path: the gang scenarios at the paper's 84
# nodes, and the trace fixtures (26-28 jobs) on 3 nodes, where they
# preempt; every policy, event mode
GANG_SCENARIOS = ("gang-heavy", "gang-trace-mix", "philly-sample",
                  "pai-sample")
GANG_ENGINE_JOBS = 384
# phase gang: the paper's 84 nodes with a sixteenth of its backlog; at
# 2**16 jobs the whole script took 902 s of its 1200 s limit on a slow
# host, and with phases sweep_engine and sweep 1370.8 s at 2**15; cut
# from 2**14 to pay for phases train and controller, and from 2**13
# after a host whose host-bound phases ran ~1.5x slower than usual took
# the whole script past its limit
GANG_JOBS = 2 ** 12
# phase trace's runs (and the reference engine's traced runs they are
# held against): fifo cut to 2**15 for the script's limit, to 2**14 to
# pay for phases train and controller, and to 2**13 for the slow host
# that phase gang's note names; fitgpp at 2**13, its traced run at the
# paper's 2**16 being phase stream's
TRACE_JOBS = {"fifo": 2 ** 13, "fitgpp": 2 ** 13}
# phase stream: fitgpp on phase paper's JobSet through the stream engine,
# its pool stream.default_capacity at 84 nodes and P = 1 (32 slots a
# node), doubled if it spills
STREAM_JOBS = PAPER_JOBS
STREAM_POOL = 32 * PAPER_NODES
# phase kernel's akey tie-break cases (tie-heavy passes with a permuted
# akey): the stream pool's pass, phase paper's and a batched one; timed
# at the pool's with and without akey
KERNEL_AKEY_SHAPES = [(1, STREAM_POOL, PAPER_NODES),
                      (1, PAPER_JOBS, PAPER_NODES), (4, 1000, PAPER_NODES)]
# phase gang's pass shape, held bit-equal in phase kernel twice: as a
# queue pass, and built like fitgpp's gang-score pass
KERNEL_GANG_SHAPE = (1, GANG_JOBS, PAPER_NODES)
ENGINE_POLICIES = ("fifo", "fitgpp", "minsize", "lrtp", "srtp", "rand")
# phase engine's card-against-CPU runs where draws decide (policy,
# scenario, nodes, jobs, P, seed): RAND's ranks (6 draws), and
# gang-heavy under fitgpp (126 over-cap signals, 5 width-1 draws), the
# last two cases of
# tests/test_torch_kernels_cuda.py::test_single_trial_draws_card_equal_cpu:
# cut from its first two (256 and 192 jobs) so that they cost no more
# than phases paper and reference save by building their JobSet once
ENGINE_DRAW_CASES = (("rand", "paper-synthetic", 8, 128, 2, 3),
                     ("fitgpp", "gang-heavy", 12, 96, 2, 5))
# phase sweep: Fig. 4 as benchmarks/paper_tables.py runs it at
# REPRO_BENCH_SCALE=full (fitgpp, P = 1, 8 workloads of 2**16 jobs from
# workload.generate at seeds 1000 * i, 84 nodes), every trial in one
# batched run_table on the card
SWEEP_S = (0.0, 1.0, 2.0, 4.0, 8.0)
# cut from the figure's 8 workloads to 4 (20 trials) for the script's
# 1200 s limit (1370.8 s with 8 and phases gang and trace uncut), and
# from 2**16 jobs to 2**14 for the slow host that phase gang's note
# names (the batched run's wall follows its iterations, which follow the
# backlog, not the number of trials)
SWEEP_WORKLOADS = 4
SWEEP_JOBS = 2 ** 14
# the figure's pass shapes at the paper's backlog, held bit-equal and
# timed in phase kernel: its 40 trials and 20 of them
KERNEL_SWEEP_SHAPES = [(len(SWEEP_S) * w, PAPER_JOBS, PAPER_NODES)
                       for w in (8, SWEEP_WORKLOADS)]
# phase sweep_engine: the JAX sweep selftest's grid (burst-storm, 8
# nodes, 64 jobs, 3 seeds x s in {0, 2, 4}, P = 1) padded with one
# sentinel trial, and gang-heavy with backfill at 84 nodes (2 seeds, cut
# from 4 to pay for phases train and controller)
SWEEP_ENGINE_GRID = ("burst-storm", 8, 64, 3, (0.0, 2.0, 4.0))
SWEEP_ENGINE_GANG = ("gang-heavy", PAPER_NODES, GANG_ENGINE_JOBS, 2, (4.0,))
# the sharded sweep (sharding/trials.py) on the one card: 4 trials (2
# seeds x s in {0, 4}) of paper-synthetic at 84 nodes and 2**10 jobs,
# fitgpp, as 2 shards in 2 processes against the one-process run
SWEEP_SHARDED = ("paper-synthetic", PAPER_NODES, 2 ** 10, 2, (0.0, 4.0))
SWEEP_SHARD_DEVICES = ("cuda:0", "cuda:0")
# flash attention: the JAX suite's shapes (tests/test_kernels.py) and
# more, each in f32 and bf16, (B, Sq, Skv, H, KV, hd, causal, window, softcap)
FLASH_SHAPES = [
    (2, 256, 256, 4, 2, 64, True, 0, 0.0),
    (1, 128, 256, 4, 1, 128, True, 0, 0.0),
    (2, 256, 256, 8, 8, 64, True, 64, 0.0),
    (1, 256, 256, 2, 1, 64, False, 0, 0.0),
    (1, 128, 128, 4, 2, 64, True, 0, 30.0),
    (2, 300, 300, 4, 2, 64, True, 0, 0.0),
    (1, 100, 260, 4, 4, 32, True, 48, 0.0),
    # the card tests' cases for the tensor-core kernel: nemotron-4-340b's
    # heads (hd 192, G 12), recurrentgemma's heads at a smaller length, a
    # causal case whose Sq*G is no multiple of 128 over several key
    # tiles, and a 2048-long case that cycles the K/V ring many times
    (1, 256, 256, 24, 2, 192, True, 0, 0.0),
    (1, 512, 512, 16, 1, 256, True, 128, 0.0),
    (2, 1000, 1000, 8, 2, 128, True, 0, 0.0),
    (1, 2048, 2048, 8, 2, 160, True, 0, 0.0),
]
# the stablelm-12b serving prefill: B 4, Sq = Skv 2048, H 32, KV 8, hd 160
SERVE_ARCH = "stablelm-12b"
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 2048, 32
FLASH_MAIN_SHAPE = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 8, 160,
                    True, 0, 0.0)
# the recurrentgemma-9b prefill's local attention: B 4, Sq = Skv 4096,
# H 16 over 1 KV head, hd 256, causal, window 2048 (the window path)
FLASH_WINDOW_SHAPE = (SERVE_BATCH, 4096, 4096, 16, 1, 256, True, 2048, 0.0)
# the prefills of phases serve_moe, serve_vlm and serve_audio: qwen3-moe
# (G 8), mixtral under its native 4096-token window, internvl2 (256
# visual + 1792 text positions) and whisper's decoder (MHA, hd 64, 224
# prompt tokens), each with its phase's name
FLASH_MODEL_SHAPES = {
    "qwen3-moe-30b-a3b": (SERVE_BATCH, 2048, 2048, 32, 4, 128, True, 0, 0.0),
    "mixtral-8x22b": (1, 8192, 8192, 48, 8, 128, True, 4096, 0.0),
    "internvl2-2b": (SERVE_BATCH, 2048, 2048, 16, 8, 128, True, 0, 0.0),
    "whisper-large-v3": (SERVE_BATCH, 224, 224, 20, 20, 64, True, 0, 0.0),
}
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


class EngineRuns:
    """What the engine phases of one call share: phase paper's untraced
    results (policy -> {"state": numpy State, "seconds", "launches",
    "fallback_count"}) and its peak device memory, phase reference's
    traced streams ((policy, n_jobs) -> (events, fallback_count)) and
    the paper cell's JobSets."""

    def __init__(self):
        self.paper = {}
        self.paper_peak_gb = None
        self.paper_wall_s = None
        self.reference_traces = {}
        self._jobsets = {}

    def jobset(self, n_jobs):
        """The paper's cell as phase paper builds it: paper-synthetic,
        84 nodes, seed 0; (cfg, JobSet, build seconds), built once per
        size."""
        from repro_torch import api, scenarios
        if n_jobs not in self._jobsets:
            cfg = api.make_config("fifo", n_jobs=n_jobs,
                                  n_nodes=PAPER_NODES, seed=0)
            t0 = time.perf_counter()
            js = scenarios.build("paper-synthetic", cfg)
            self._jobsets[n_jobs] = (cfg, js, time.perf_counter() - t0)
        return self._jobsets[n_jobs]


# the script's start on the host clock; each phase line carries the
# seconds since then (``elapsed_s``) and since the line before it
# (``phase_s``), so a run shows what each phase cost
_START = time.perf_counter()
_LAST = [_START]


def emit(obj) -> None:
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "elapsed_s": now - _START, "phase_s": now - _LAST[0]}
        _LAST[0] = now
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


def tie_instance(np, J, M, seed):
    """A tie-heavy pass like the stream engine's pool passes: two demand
    rows and two grace periods (the Eq. 3 scores take four values),
    free capacity that keeps most candidates Eq. 2 eligible, live cand
    and under masks, and ``akey`` a seeded permutation."""
    inst = rand_instance(np, J, M, seed)
    rng = np.random.default_rng(seed + 500)
    rows = np.array([[4.0, 16.0, 1.0], [8.0, 32.0, 2.0]], np.float32)
    inst.update(demand=rows[rng.integers(0, 2, J)],
                gp=rng.choice(np.array([0.0, 4.0], np.float32), J),
                free=np.tile(np.array([[8.0, 64.0, 4.0]], np.float32),
                             (M, 1)))
    inst["akey"] = rng.permutation(J).astype(np.float32)
    return inst


def gang_score_instance(np, J, M, seed):
    """Arguments like fitgpp's gang-score pass (``sim_torch``'s
    ``gang_score``): jobs of width 1, 2, 4 or 8 on as many consecutive
    nodes, each job's total demand (demand * width), live cand and under
    masks, no BE queue and a zero TE demand."""
    inst = rand_instance(np, J, M, seed)
    rng = np.random.default_rng(seed + 1000)
    width = rng.choice(np.array([1, 2, 4, 8], np.int32), J)
    cols = (rng.integers(0, M, J)[:, None] + np.arange(8)) % M
    keep = np.arange(8) < width[:, None]
    assign = np.zeros((J, M), bool)
    assign[np.nonzero(keep)[0], cols[keep]] = True
    inst.update(width=width, assign=assign,
                demand=inst["demand"] * width[:, None].astype(np.float32),
                be_q=np.zeros(J, bool),
                te_demand=np.zeros(3, np.float32))
    return inst


def batched_args(torch, np, B, J, M, seed, kind="rand"):
    """Stacked (B, ...) kernel arguments on the card, normalizers and
    s included. ``kind``: "rand" (:func:`rand_instance`), "empty" (its
    cand, under and be_q all False), "gang_score"
    (:func:`gang_score_instance`) or "ties" (:func:`tie_instance`,
    whose ``akey`` comes last)."""
    from repro_torch.kernels import ops
    make = {"gang_score": gang_score_instance,
            "ties": tie_instance}.get(kind, rand_instance)
    insts = [make(np, J, M, seed + b) for b in range(B)]
    akey = None
    if kind == "ties":
        akey = torch.stack([torch.as_tensor(i.pop("akey"))
                            for i in insts]).cuda()
    if kind == "empty":
        for inst in insts:
            for k in ("cand", "under", "be_q"):
                inst[k][:] = False
    args = [torch.stack([torch.as_tensor(i[k]) for i in insts]).cuda()
            for k in insts[0]]
    norms = [ops.normalizers(args[0][b], args[1][b], args[7][b],
                             args[11][b]) for b in range(B)]
    return args + [torch.stack([n[0] for n in norms]),
                   torch.stack([n[1] for n in norms]),
                   torch.full((B,), 4.0, device="cuda")] \
        + ([] if akey is None else [akey])


def bound_ms(B, J, M, n_assigned, akey=False):
    """Least time for one pass at this shape: bytes (each input read
    once, each output written once; ``akey`` adds its 4 bytes a job)
    over HBM bandwidth against float32 operations over the float32
    rate; returns (ms, bound_by)."""
    inputs = B * (J * (12 + 4 + 4 + 4 + M + 3 + 4 * akey) + M * 24 + 24
                  + 12)
    outputs = B * (J * (4 + 4 * M + 8) + 16)
    # per (job, node): 6 fit compares; per assigned entry: Eq. 2 slack
    # (3 adds, 3 subtracts, 2 min, 1 max); per job: Eq. 1/3 (12), the
    # demand - eps row (3) and the nskip test (3 compares)
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
    """Device time of the schedule_step kernel (one launch a pass), from
    the events the wrapper records right around its launch, median over
    ``reps`` calls queued behind a spin kernel, in ms."""
    for _ in range(3):
        ss.schedule_step_cuda(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    events = []
    for _ in range(reps):
        ss.schedule_step_cuda(*args, events=events)
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


_PROFILE_ONE_PASS = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import chip_smoke
from repro_torch.kernels import schedule_step as ss
args = chip_smoke.batched_args(torch, np, {B}, {J}, {M}, 99)
ss.schedule_step_cuda(*args)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    ss.schedule_step_cuda(*args)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]))
"""


def device_kernels_of_one_pass(B, J, M):
    """Names of the device kernels that one schedule_step_cuda call
    launches at (B, J, M), one entry a launch, from ``torch.profiler``
    in a fresh process: a second profiling session in one process can
    miss a single short kernel's device record."""
    code = _PROFILE_ONE_PASS.format(root=ROOT, src=os.path.join(ROOT, "src"),
                                    B=B, J=J, M=M)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"profiling one schedule_step call failed:\n"
          f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


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


def check_pass_equal(torch, ss, args, where):
    """One kernel call against the plain version, all 8 fields
    bit-equal, counted as one launch; returns (kernel pass, max abs
    difference)."""
    before = ss.build.LAUNCHES["schedule_step"]
    k = ss.schedule_step_cuda(*args)
    check(ss.build.LAUNCHES["schedule_step"] == before + 1,
          "schedule_step_cuda did not count one launch")
    p = ss.schedule_step_torch(*args)
    torch.cuda.synchronize()
    max_err = 0.0
    for name, x, y in zip(ss.SchedulePass._fields, k, p):
        check(x.dtype == y.dtype and x.shape == y.shape,
              f"schedule_step {name}: {x.dtype}{tuple(x.shape)} vs "
              f"{y.dtype}{tuple(y.shape)} {where}")
        err = float((x.double() - y.double()).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(x, y), f"schedule_step {name} differs from "
              f"the plain version {where} (max {err})")
    return k, max_err


def kernel_akey(torch, np, ss):
    """The victim's akey tie-break at KERNEL_AKEY_SHAPES on tie-heavy
    passes: kernel == plain version with akey and without it (today's
    path), the tie-break changing victims; then the pass at the stream
    pool's shape timed with and without akey, with its bound."""
    max_err = 0.0
    changed = 0
    for seed, (B, J, M) in enumerate(KERNEL_AKEY_SHAPES, 200):
        args = batched_args(torch, np, B, J, M, seed, "ties")
        where = f"with akey at B={B} J={J} M={M}"
        k, err = check_pass_equal(torch, ss, args, where)
        k0, err0 = check_pass_equal(torch, ss, args[:-1],
                                    where.replace("with", "without"))
        max_err = max(max_err, err, err0)
        changed += int((k.victim != k0.victim).sum())
        del args, k, k0
        free_cuda(torch)
    check(changed > 0, "the akey tie-break changed no victim")
    B, J, M = KERNEL_AKEY_SHAPES[0]
    args = batched_args(torch, np, B, J, M, 299, "ties")
    bound, bound_by = bound_ms(B, J, M, int(args[4].sum()), akey=True)
    out = {"shape": {"B": B, "J": J, "M": M},
           "cases": len(KERNEL_AKEY_SHAPES), "victims_changed": changed,
           "ms": time_kernel_ms(torch, ss, args),
           "ms_without_akey": time_kernel_ms(torch, ss, args[:-1]),
           "plain_ms": time_ms(torch, lambda: ss.schedule_step_torch(*args)),
           "bound_ms": bound, "bound_by": bound_by,
           "bound_ms_without_akey": bound_ms(B, J, M,
                                             int(args[4].sum()))[0]}
    return out, max_err


def phase_kernel(torch, np, shapes=KERNEL_SHAPES):
    """Kernel against plain version, all 8 fields bit-equal, at
    KERNEL_SHAPES, an empty-mask case, KERNEL_WIDE_SHAPE,
    KERNEL_NODES_SHAPES, KERNEL_MANY_NODES_TIMED, KERNEL_GANG_SHAPE
    (a random pass and a gang-score pass), KERNEL_SWEEP_SHAPES (also
    timed, with their bounds) and the akey tie-break
    (:func:`kernel_akey`); each call counted as one launch, and the
    device kernels of one call at the timed shape counted by the
    profiler."""
    from repro_torch.kernels import schedule_step as ss
    cases = [(b, j, m, "rand") for b, j, m in shapes] \
        + [(1, 1000, 84, "empty"), (*KERNEL_WIDE_SHAPE, "rand")] \
        + [(*shape, "rand") for shape in KERNEL_NODES_SHAPES] \
        + [(*KERNEL_MANY_NODES_TIMED, "rand"), (*KERNEL_GANG_SHAPE, "rand"),
           (*KERNEL_GANG_SHAPE, "gang_score")] \
        + [(*shape, "rand") for shape in KERNEL_SWEEP_SHAPES]
    max_err = 0.0
    for seed, (B, J, M, kind) in enumerate(cases):
        args = batched_args(torch, np, B, J, M, seed, kind)
        _, err = check_pass_equal(torch, ss, args, f"at B={B} J={J} M={M}")
        max_err = max(max_err, err)
        del args
        free_cuda(torch)
    akey, err = kernel_akey(torch, np, ss)
    max_err = max(max_err, err)
    B, J, M = 1, PAPER_JOBS, PAPER_NODES
    args = batched_args(torch, np, B, J, M, 99)
    ms = time_kernel_ms(torch, ss, args)
    wrapper_ms = time_ms(torch, lambda: ss.schedule_step_cuda(*args),
                         queued=False)
    plain_ms = time_ms(torch, lambda: ss.schedule_step_torch(*args))
    per_pass = device_kernels_of_one_pass(B, J, M)
    check(len(per_pass) == 1 and "schedule_step_kernel" in per_pass[0],
          f"one schedule_step_cuda call ran the device kernels {per_pass}")
    plain_idle_ms = time_ms(torch, lambda: ss.schedule_step_torch(*args),
                            queued=False)
    bound, bound_by = bound_ms(B, J, M, int(args[4].sum()))
    del args
    shape = KERNEL_MANY_NODES_TIMED
    nodes_args = batched_args(torch, np, *shape, 98)
    many_nodes = {
        "shape": dict(zip("BJM", shape)),
        "ms": time_kernel_ms(torch, ss, nodes_args),
        "plain_ms": time_ms(torch, lambda: ss.schedule_step_torch(
            *nodes_args)),
        "bound_ms": bound_ms(*shape, int(nodes_args[4].sum()))[0]}
    del nodes_args
    free_cuda(torch)
    sweep_pass = []
    for shape in KERNEL_SWEEP_SHAPES:
        sweep_args = batched_args(torch, np, *shape, 97)
        sweep_bound, sweep_bound_by = bound_ms(*shape,
                                               int(sweep_args[4].sum()))
        sweep_pass.append({
            "shape": dict(zip("BJM", shape)),
            "ms": time_kernel_ms(torch, ss, sweep_args),
            "plain_ms": time_ms(torch, lambda: ss.schedule_step_torch(
                *sweep_args)),
            "bound_ms": sweep_bound, "bound_by": sweep_bound_by})
        del sweep_args
        free_cuda(torch)
    result = {"name": "schedule_step", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/schedule_step.cu",
              "replaces": "src/repro/kernels/schedule_step.py:233",
              "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
              "kernels_per_pass": len(per_pass),
              "kernels_of_one_pass": per_pass,
              "wrapper_idle_ms": wrapper_ms, "plain_idle_ms": plain_idle_ms,
              "many_nodes": many_nodes, "sweep_pass": sweep_pass,
              "akey": akey, "timed_shape": {"B": B, "J": J, "M": M}}
    emit({"phase": "kernel", "cases": len(cases), "all_equal": True,
          "gang_cases": {"shape": dict(zip("BJM", KERNEL_GANG_SHAPE)),
                         "kinds": ["rand", "gang_score"]},
          "tolerance": "bit-exact, all 8 fields", **result})
    return result


def kernel_vs_plain(torch, cfg, jobs, what):
    """Run ``cfg`` on ``jobs`` (on the card) along the kernel path and
    along the plain path; the two final States must be equal field for
    field, the draw count included. Returns the kernel path's State (as
    numpy), the two wall times and the kernel path's launches."""
    from repro_torch.core import sim_torch
    from repro_torch.kernels import ops
    out = {}
    launches = 0
    for path, force in (("kernel", False), ("plain", True)):
        ops._FORCE_PLAIN = force
        try:
            before = ops.LAUNCHES["schedule_step"]
            t0 = time.perf_counter()
            st = sim_torch.run(cfg, jobs, cfg.seed)
            torch.cuda.synchronize()
            out[path] = (sim_torch.state_to_numpy(st),
                         time.perf_counter() - t0)
            if not force:
                launches = ops.LAUNCHES["schedule_step"] - before
        finally:
            ops._FORCE_PLAIN = False
    diff = sim_torch.state_diff_fields(out["kernel"][0], out["plain"][0])
    check(not diff, f"{what}: kernel-path State differs from the plain "
          f"path in {diff}")
    st = out["kernel"][0]
    check(int(st["n_done"]) == len(st["state"]), f"{what}: run did not "
          "finish")
    check(launches > 0, f"{what}: the kernel path launched no kernel")
    return st, out["kernel"][1], out["plain"][1], launches


def phase_engine(torch, n_jobs=ENGINE_JOBS):
    """The engine's kernel path against its plain path on the card (same
    seed, full State equal, draw count included): paper-synthetic; the
    gang scenarios under every policy; gang-heavy with backfill. Then
    the card against the CPU plain path where draws decide: RAND on a
    small contended paper-synthetic input, and fitgpp on gang-heavy
    (over-cap signals, a drawn fallback): the draws are counter-based,
    so the card's State equals the CPU's field for field."""
    from repro_torch import api, scenarios
    from repro_torch.core import sim_torch
    cfg = api.make_config("fifo", n_jobs=n_jobs, n_nodes=PAPER_NODES,
                          seed=0)
    jobs = sim_torch.jobs_from_jobset(scenarios.build("paper-synthetic",
                                                      cfg), "cuda")
    for policy in ("fitgpp", "lrtp"):
        st, k_s, p_s, _ = kernel_vs_plain(
            torch, dataclasses.replace(cfg, policy=policy), jobs, policy)
        emit({"phase": "engine_kernel_vs_plain", "policy": policy,
              "n_jobs": n_jobs, "equal": True,
              "fallback_count": int(st["fallback_count"]),
              "preemptions": int(st["preempt_count"].sum()),
              "kernel_path_s": k_s, "plain_path_s": p_s})
    t0 = time.perf_counter()
    cases = []
    for scenario in GANG_SCENARIOS:
        for n_nodes in ((PAPER_NODES, 3) if "sample" in scenario
                        else (PAPER_NODES,)):
            gcfg = api.make_config("fifo", n_jobs=GANG_ENGINE_JOBS,
                                   n_nodes=n_nodes, seed=0)
            js = scenarios.build(scenario, gcfg)
            gjobs = sim_torch.jobs_from_jobset(js, "cuda")
            runs = [(p, False) for p in ENGINE_POLICIES]
            if scenario == "gang-heavy":
                runs += [("srtp", True), ("fitgpp", True)]
            for policy, backfill in runs:
                what = f"{scenario}/{n_nodes} nodes/{policy}" \
                    + ("/backfill" if backfill else "")
                st, k_s, p_s, launches = kernel_vs_plain(
                    torch, dataclasses.replace(gcfg, policy=policy,
                                               backfill=backfill),
                    gjobs, what)
                cases.append({
                    "scenario": scenario, "n_nodes": n_nodes,
                    "n_jobs": js.n, "gangs": int((js.n_nodes > 1).sum()),
                    "policy": policy, "backfill": backfill,
                    "preemptions": int(st["preempt_count"].sum()),
                    "fallback_count": int(st["fallback_count"]),
                    "launches": launches, "kernel_path_s": k_s,
                    "plain_path_s": p_s})
    check(any(c["preemptions"] > 0 and c["n_jobs"] < 100 for c in cases),
          "no trace-fixture case preempted")
    emit({"phase": "engine_gang_kernel_vs_plain", "equal": True,
          "cases": len(cases), "seconds": time.perf_counter() - t0,
          "preempting_cases": sum(c["preemptions"] > 0 for c in cases),
          "runs": cases})
    t0 = time.perf_counter()
    draws = []
    for policy, scenario, nodes, n, P, seed in ENGINE_DRAW_CASES:
        small = api.make_config(policy, n_jobs=n, n_nodes=nodes, seed=seed,
                                P=P)
        js = scenarios.build(scenario, small)
        states = [sim_torch.state_to_numpy(sim_torch.run(
            small, sim_torch.jobs_from_jobset(js, dev), seed))
            for dev in ("cuda", "cpu")]
        what = f"{scenario}/{policy}"
        check(states[1]["draws"] > 0, f"{what}: no draw")
        check(policy == "rand" or states[1]["fallback_count"] > 0,
              f"{what}: no fallback")
        diff = sim_torch.state_diff_fields(*states)
        check(not diff, f"{what}: the card's State differs from the CPU's "
              f"in {diff}")
        draws.append({"scenario": scenario, "policy": policy, "n_jobs": n,
                      "n_nodes": nodes, "draws": int(states[0]["draws"]),
                      "fallback_count": int(states[0]["fallback_count"]),
                      "preemptions": int(states[0]["preempt_count"].sum())})
    emit({"phase": "engine_card_vs_cpu", "equal": True, "runs": draws,
          "seconds": time.perf_counter() - t0})


def phase_paper(torch, np, runs, n_jobs=PAPER_JOBS):
    """The main path: ``api.run_experiment`` of fifo and fitgpp on the
    paper's cell (the JobSet built once, ``runs.jobset``, shared with
    phases reference and stream, as ``api.compare_policies`` shares
    one); each policy's result is kept in ``runs.paper``. Its wall time
    holds the JobSet's build, as ``compare_policies``'s did."""
    from repro_torch import api
    from repro_torch.core import sim_torch
    from repro_torch.kernels import ops
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    ops.KERNEL_EVENTS = []
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        cfg, js, build_s = runs.jobset(n_jobs)
        rs = {p: api.run_experiment(cfg=cfg, policy=p, jobs=js)
              for p in ("fifo", "fitgpp")}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.paper_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = ops.LAUNCHES["schedule_step"]
        kernel_ms = [s.elapsed_time(e) for s, e in ops.KERNEL_EVENTS]
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
        runs.paper[policy] = {
            "state": sim_torch.state_to_numpy(st), "seconds": r.raw.seconds,
            "launches": r.raw.launches, "fallback_count": r.fallback_count}
        per_policy[policy] = {
            "wall_s": r.raw.seconds, "iterations": r.raw.iterations,
            "launches": r.raw.launches,
            "kernel_ms": sum(kernel_ms[k0:k1]),
            "TE": r.table["TE"], "BE": r.table["BE"],
            "preempted_frac": r.preempted_frac, "makespan": r.makespan,
            "fallback_count": r.fallback_count}
        k0 = k1
    fifo, fit = rs["fifo"].table, rs["fitgpp"].table
    te_cut = 1.0 - fit["TE"]["p95"] / fifo["TE"]["p95"]
    runs.paper_wall_s = wall
    emit({"phase": "paper_scale", "n_jobs": n_jobs, "n_nodes": PAPER_NODES,
          "wall_s": wall, "build_s": build_s, "launches": launches,
          "peak_device_gb": runs.paper_peak_gb,
          "kernel_ms_total": sum(kernel_ms),
          "kernel_events_in_wall": True,
          "te_p95_cut": te_cut,
          "be_p50_worsening": fit["BE"]["p50"] / fifo["BE"]["p50"] - 1.0,
          "be_p95_worsening": fit["BE"]["p95"] / fifo["BE"]["p95"] - 1.0,
          "policies": per_policy})
    check(te_cut >= 0.80, f"TE p95 cut {te_cut:.1%} < 80%")
    return launches


def phase_gang(torch, np, n_jobs=GANG_JOBS):
    """The gang workload on the paper's cluster: gang-heavy (half the
    jobs gangs of 2, 4 or 8 nodes) on 84 nodes, closed-loop load 2.0,
    seed 0, event mode, under fifo, fitgpp and fitgpp with backfill,
    through ``api.run_experiment`` on one shared JobSet."""
    from repro_torch import api, scenarios
    from repro_torch.kernels import ops
    cfg = api.make_config("fifo", n_jobs=n_jobs, n_nodes=PAPER_NODES,
                          seed=0)
    t0 = time.perf_counter()
    js = scenarios.build("gang-heavy", cfg)
    build_s = time.perf_counter() - t0
    zero_launches()
    ops.KERNEL_EVENTS = []
    t0 = time.perf_counter()
    runs = {}
    try:
        for name, policy, backfill in (("fifo", "fifo", False),
                                       ("fitgpp", "fitgpp", False),
                                       ("fitgpp_backfill", "fitgpp", True)):
            r = api.run_experiment("gang-heavy", policy, cfg=cfg, jobs=js,
                                   backfill=backfill, mode="event")
            runs[name] = (policy, backfill, r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernel_ms = [s.elapsed_time(e) for s, e in ops.KERNEL_EVENTS]
    finally:
        ops.KERNEL_EVENTS = None
    launches = ops.LAUNCHES["schedule_step"]
    check(launches == len(kernel_ms) == sum(r.raw.launches for _, _, r
                                            in runs.values()),
          "gang launches do not add up")
    k0 = 0
    for name, (policy, backfill, r) in runs.items():
        st = r.raw.state
        check(st.n_done == n_jobs, f"gang {name}: {st.n_done} of {n_jobs} "
              "jobs done")
        check(bool((st.finish >= 0).all()), f"gang {name}: unfinished jobs")
        check(all(np.isfinite(v) for t in r.table.values()
                  for v in t.values()), f"gang {name}: non-finite "
              "slowdown percentiles")
        # every acting tick runs at least one schedule pass, each one
        # launch of the kernel
        check(r.raw.acting_ticks > 0
              and r.raw.launches >= r.raw.acting_ticks,
              f"gang {name}: {r.raw.launches} launches for "
              f"{r.raw.acting_ticks} acting ticks")
        k1 = k0 + r.raw.launches
        run_kernel_ms = sum(kernel_ms[k0:k1])
        k0 = k1
        runs[name] = {
            "policy": policy, "backfill": backfill,
            "TE": r.table["TE"], "BE": r.table["BE"],
            "fallback_count": r.fallback_count,
            "preemptions": int(st.preempt_count.sum()),
            "preempted_frac": r.preempted_frac, "makespan": r.makespan,
            "wall_s": r.raw.seconds, "iterations": r.raw.iterations,
            "acting_ticks": r.raw.acting_ticks, "launches": r.raw.launches,
            "kernel_ms": run_kernel_ms,
            "kernel_share": run_kernel_ms / 1e3 / r.raw.seconds,
            "all_finished": True}
    fifo = runs["fifo"]

    def vs_fifo(run):
        return {"te_p95_cut": 1.0 - run["TE"]["p95"] / fifo["TE"]["p95"],
                "be_p50_worsening": run["BE"]["p50"] / fifo["BE"]["p50"]
                - 1.0,
                "be_p95_worsening": run["BE"]["p95"] / fifo["BE"]["p95"]
                - 1.0}

    emit({"phase": "gang", "scenario": "gang-heavy", "n_jobs": n_jobs,
          "n_nodes": PAPER_NODES, "gangs": int((js.n_nodes > 1).sum()),
          "build_s": build_s, "wall_s": wall, "launches": launches,
          "kernel_ms_total": sum(kernel_ms), "kernel_events_in_wall": True,
          "fitgpp_vs_fifo": vs_fifo(runs["fitgpp"]),
          "fitgpp_backfill_vs_fifo": vs_fifo(runs["fitgpp_backfill"]),
          "runs": runs})
    return launches


def first_difference(np, a, b):
    d = np.flatnonzero(np.asarray(a) != np.asarray(b))
    return int(d[0]) if d.size else None


def reference_run(runs, policy, n_jobs, trace):
    """One host numpy reference run on the paper's cell, as
    ``api.run_experiment(engine="reference")`` makes it; returns the
    result, its fallback count and the wall seconds of building and
    running the simulator, the span the torch engine's ``raw.seconds``
    covers (its State's set-up and loop)."""
    from repro_torch import api
    from repro_torch.core import simulator
    cfg, js, _ = runs.jobset(n_jobs)
    cfg = api.make_config(policy, base=cfg)
    t0 = time.perf_counter()
    sim = simulator.Simulator(cfg, js, trace=trace)
    res = sim.run(mode="event")
    return res, sim.policy.fallback_count, time.perf_counter() - t0


def phase_reference(np, runs, n_jobs=PAPER_JOBS, stream=False):
    """The same-host baseline: the port's numpy reference engine (host
    only, never the card) on the paper's cell under fifo and fitgpp,
    untraced; its results held against phase paper's torch runs (finish
    ticks, preemption counts and the slowdown table, bit for bit, where
    neither run drew a random fallback). Then the traced fifo and
    fitgpp runs at their TRACE_JOBS sizes that phase trace compares
    streams with (fitgpp's where neither engine fell back), and with
    ``stream`` the traced fitgpp run at STREAM_JOBS that phase stream
    compares per-job events with."""
    from repro_torch.core import metrics
    from repro_torch.core.types import SimResult
    _, js, build_s = runs.jobset(n_jobs)
    out = {}
    for policy in ("fifo", "fitgpp"):
        res, fallback, wall = reference_run(runs, policy, n_jobs,
                                            trace=False)
        table = metrics.slowdown_table(res)
        check(bool((res.finish > 0).all()), f"reference {policy}: "
              "unfinished jobs")
        check(all(np.isfinite(v) for t in table.values()
                  for v in t.values()), f"reference {policy}: non-finite "
              "slowdown percentiles")
        run = {"wall_s": wall, "TE": table["TE"], "BE": table["BE"],
               "preempted_frac": res.preempted_fraction(),
               "makespan": int(res.makespan),
               "preemptions": int(res.preempt_count.sum()),
               "fallback_count": fallback}
        torch_run = runs.paper.get(policy)
        if torch_run is not None:
            st = torch_run["state"]
            run["torch_wall_s"] = torch_run["seconds"]
            run["torch_over_reference"] = torch_run["seconds"] / wall
            run["torch_fallback_count"] = torch_run["fallback_count"]
            exact = policy == "fifo" or (
                fallback == 0 and torch_run["fallback_count"] == 0)
            first = first_difference(np, st["finish"], res.finish)
            run["first_finish_difference"] = first
            if exact:
                check(first is None, f"reference {policy}: finish differs "
                      f"from the torch engine's from job {first}")
                check(np.array_equal(st["preempt_count"], res.preempt_count),
                      f"reference {policy}: preemption counts differ")
                torch_res = SimResult(
                    finish=st["finish"].astype(np.int64),
                    exec_total=res.exec_total, submit=res.submit,
                    is_te=res.is_te, preempt_count=res.preempt_count)
                check(metrics.slowdown_table(torch_res) == table,
                      f"reference {policy}: slowdown tables differ")
            run["equal_to_torch"] = exact
        out[policy] = run
    fifo, fit = out["fifo"]["TE"], out["fitgpp"]["TE"]
    # the traced runs phase trace compares streams with
    traced = {}
    todo = [(p, TRACE_JOBS[p]) for p in ("fifo", "fitgpp")] \
        + ([("fitgpp", STREAM_JOBS)] if stream else [])
    for policy, n in todo:
        res, fallback, wall = reference_run(runs, policy, n, trace=True)
        runs.reference_traces[policy, n] = (res.trace, fallback)
        traced[f"{policy}_{n}"] = {"n_jobs": n, "wall_s": wall,
                                   "events": len(res.trace),
                                   "fallback_count": fallback}
    emit({"phase": "reference", "scenario": "paper-synthetic",
          "n_jobs": n_jobs, "n_nodes": PAPER_NODES, "build_s": build_s,
          "te_p95_cut": 1.0 - fit["p95"] / fifo["p95"],
          "runs": out, "traced": traced})


def check_decomposition(events, finish, exec_total, n_jobs, where):
    """The slowdown decomposition's identity for every job, its finish
    the run's and its service the execution time; returns the
    decomposition."""
    from repro_torch.obs import timeseries
    dec = timeseries.slowdown_decomposition(events)
    check(sorted(dec) == list(range(n_jobs)), f"{where}: the "
          "decomposition misses jobs")
    bad = [j for j, d in dec.items()
           if not d.identity_holds() or d.finish != finish[j]
           or d.service != int(exec_total[j])]
    check(not bad, f"{where}: the decomposition fails for {len(bad)} "
          f"jobs, first {bad[:1]}")
    return dec


def phase_trace(torch, np, runs):
    """The torch engine traced on the paper's cell under fifo and
    fitgpp (2**13 jobs, TRACE_JOBS; its traced run at 2**16 is
    phase stream's), event mode, the default ring capacity, through
    ``api.run_experiment(trace=True)``: no overflow, a valid stream,
    the slowdown decomposition's identity for every job (service equal
    to the execution time, finish to the State's), the stream equal to
    the reference engine's event for event (fifo; fitgpp where neither
    fell back) and, for a run at phase paper's size where phase paper
    ran, every other State field and the launches equal to its untraced
    run."""
    from repro_torch import api
    from repro_torch.core import metrics, sim_torch
    from repro_torch.kernels import ops
    from repro_torch.obs import schema
    zero_launches()
    t0 = time.perf_counter()
    out = {}
    for policy in ("fifo", "fitgpp"):
        cfg, js, _ = runs.jobset(TRACE_JOBS[policy])
        t1 = time.perf_counter()
        r = api.run_experiment("paper-synthetic", policy, cfg=cfg, jobs=js,
                               mode="event", trace=True)
        run_s = time.perf_counter() - t1
        st = r.raw.state
        events = r.events
        check(r.trace_overflow == 0, f"trace {policy}: the ring dropped "
              f"{r.trace_overflow} rows")
        check(st.ev_n == len(events), f"trace {policy}: ev_n {st.ev_n} "
              f"!= {len(events)} events")
        t1 = time.perf_counter()
        schema.validate_events(events, n_jobs=js.n, n_nodes=PAPER_NODES)
        validate_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        dec = check_decomposition(events, st.finish.cpu().numpy(),
                                  js.exec_total, js.n, f"trace {policy}")
        decomp_s = time.perf_counter() - t1
        run = {"n_jobs": js.n, "traced_wall_s": r.raw.seconds,
               "run_experiment_s": run_s, "ev_n": st.ev_n,
               "ring_rows": st.ev_buf.shape[0],
               "ring_mb": st.ev_buf.numel() * 4 / 1e6,
               "launches": r.raw.launches, "iterations": r.raw.iterations,
               "fallback_count": r.fallback_count,
               "validate_s": validate_s, "decomposition_s": decomp_s,
               "preempted_jobs": sum(d.grace_stall > 0 or d.requeue_wait > 0
                                     for d in dec.values())}
        paper = runs.paper.get(policy)
        if paper is not None and js.n == PAPER_JOBS:
            untraced = paper["state"]
            diff = [f for f in sim_torch.state_diff_fields(
                untraced, sim_torch.state_to_numpy(st))
                if f not in ("ev_buf", "ev_n")]
            check(not diff, f"trace {policy}: the traced State differs "
                  f"from phase paper's untraced one in {diff}")
            check(r.raw.launches == paper["launches"], f"trace {policy}: "
                  f"{r.raw.launches} launches, untraced {paper['launches']}")
            run["untraced_wall_s"] = paper["seconds"]
            run["traced_over_untraced"] = r.raw.seconds / paper["seconds"]
            run["equal_to_untraced"] = True
        ref = runs.reference_traces.get((policy, js.n))
        if ref is None and policy == "fifo":
            res, fallback, _ = reference_run(runs, "fifo",
                                             TRACE_JOBS["fifo"], trace=True)
            ref = (res.trace, fallback)
        if ref is not None and (
                policy == "fifo" or ref[1] == r.fallback_count == 0):
            metrics.assert_trace_parity(ref[0], events)
            run["equal_to_reference_stream"] = True
        else:
            run["equal_to_reference_stream"] = None
        check(policy != "fifo" or run["equal_to_reference_stream"],
              "trace fifo: not compared with the reference stream")
        out[policy] = run
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["schedule_step"]
    check(launches == sum(r["launches"] for r in out.values()) > 0,
          "trace launches do not add up")
    emit({"phase": "trace", "scenario": "paper-synthetic",
          "n_nodes": PAPER_NODES, "wall_s": wall, "launches": launches,
          "runs": out})
    return launches


def export_round_trip(events, is_te, where):
    """Write ``events`` as CSV and Perfetto JSON to a temporary
    directory and read the CSV back; returns seconds and sizes."""
    from repro_torch.obs import export
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "events.csv")
        json_path = os.path.join(tmp, "events.perfetto.json")
        t1 = time.perf_counter()
        export.write_trace(csv_path, events, fmt="csv")
        export.write_trace(json_path, events, fmt="perfetto",
                           n_nodes=PAPER_NODES, is_te=is_te)
        export_s = time.perf_counter() - t1
        with open(csv_path) as f:
            check(export.read_csv(f.read()) == events,
                  f"{where}: the CSV does not read back equal")
        with open(json_path) as f:
            check(bool(json.load(f)["traceEvents"]), f"{where}: empty "
                  "Perfetto export")
        return {"export_s": export_s,
                "csv_mb": os.path.getsize(csv_path) / 1e6,
                "perfetto_mb": os.path.getsize(json_path) / 1e6}


def events_by_job(events):
    """job -> its events in stream order, each (t, code, aux, nodes)."""
    out = {}
    for e in events:
        out.setdefault(e.job, []).append((e.t, e.code, e.aux,
                                          tuple(e.nodes)))
    return out


def phase_stream(torch, np, runs, n_jobs=STREAM_JOBS):
    """The stream engine on the main path: fitgpp on phase paper's
    JobSet (paper-synthetic, 84 nodes, 2**16 jobs, seed 0, event mode)
    through ``StreamEngine(cfg, from_jobset(js), admission=True,
    trace=True)`` with a pool of STREAM_POOL slots
    (``stream.default_capacity``), doubled while a run spills. Checks:
    the streamed admit times equal the JobSet's submit times; no spill,
    no ring overflow; finish, preemption counts, last signal, vacate
    and resume ticks and the makespan equal phase paper's fitgpp State
    where neither run drew a random fallback; the remapped events are
    valid, decompose for every job and survive the CSV and Perfetto
    export; each job's events, in order, equal the reference engine's
    traced run (phase reference) where neither fell back."""
    from repro_torch import api
    from repro_torch.core import stream
    from repro_torch.kernels import ops
    from repro_torch.obs import schema
    base, js, _ = runs.jobset(n_jobs)
    cfg = api.make_config("fitgpp", base=base)
    capacity = stream.default_capacity(cfg)
    check(capacity == STREAM_POOL, f"default capacity {capacity}, not "
          f"{STREAM_POOL}")
    tried = []
    while True:
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = stream.StreamEngine(cfg, stream.from_jobset(js),
                                  capacity=capacity, time_mode="event",
                                  trace=True, admission=True).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES["schedule_step"]
        tried.append({"capacity": capacity, "n_spilled": res.n_spilled,
                      "wall_s": wall})
        if res.n_spilled == 0 or len(tried) == 4:
            break
        capacity *= 2
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(res.n_spilled == 0, f"stream: {res.n_spilled} jobs spilled at "
          f"every capacity tried {tried}")
    check(launches > 0, "the stream engine launched no schedule_step "
          "kernel")
    check(res.n_jobs == js.n and res.trace_overflow == 0,
          f"stream: {res.n_jobs} of {js.n} jobs, {res.trace_overflow} "
          "ring rows dropped")
    check(np.array_equal(res.submit, js.submit), "stream: the closed-loop "
          "admit times differ from the JobSet's submit times")
    run = {"n_jobs": res.n_jobs, "capacity": capacity, "tried": tried,
           "rounds": res.rounds, "max_live": res.max_live,
           "wall_s": wall, "launches": launches,
           "iterations": res.iterations, "acting_ticks": res.acting_ticks,
           "peak_device_gb": peak_gb, "paper_peak_device_gb":
           runs.paper_peak_gb, "fallback_count": res.fallback_count,
           "makespan": res.makespan, "events": len(res.events),
           "TE": res.summary()["TE"], "BE": res.summary()["BE"]}
    paper = runs.paper.get("fitgpp")
    run["equal_to_paper"] = None
    if paper is not None:
        run["paper_wall_s"] = paper["seconds"]
        run["paper_launches"] = paper["launches"]
        if res.fallback_count == paper["fallback_count"] == 0:
            st = paper["state"]
            diff = [k for k in ("finish", "preempt_count", "last_signal",
                                "last_vacate", "last_resume")
                    if not np.array_equal(st[k], getattr(res, k))]
            check(not diff, f"stream: {diff} differ from phase paper's "
                  "fitgpp State")
            check(res.makespan == int(st["t"]), f"stream: makespan "
                  f"{res.makespan}, phase paper's {int(st['t'])}")
            run["equal_to_paper"] = True
    t1 = time.perf_counter()
    schema.validate_events(res.events, n_jobs=js.n, n_nodes=PAPER_NODES)
    check_decomposition(res.events, res.finish, js.exec_total, js.n,
                        "stream")
    run["validate_s"] = time.perf_counter() - t1
    run.update(export_round_trip(res.events, js.is_te, "stream"))
    ref = runs.reference_traces.get(("fitgpp", n_jobs))
    run["equal_to_reference_per_job"] = None
    if ref is not None and ref[1] == res.fallback_count == 0:
        want, got = events_by_job(ref[0]), events_by_job(res.events)
        bad = [j for j in range(js.n) if want.get(j) != got.get(j)]
        check(not bad, f"stream: {len(bad)} jobs' events differ from the "
              f"reference engine's, first {bad[:1]}")
        run["equal_to_reference_per_job"] = True
    emit({"phase": "stream", "scenario": "paper-synthetic",
          "policy": "fitgpp", "n_nodes": PAPER_NODES, **run})
    return launches


def sweep_table(np, scenario, n_nodes, n_jobs, n_seeds, s_vals):
    """(cfg, per-trial JobSets, TrialTable) of a sweep_engine grid: the
    scenario at seeds 0..n_seeds-1, each under every s of ``s_vals``,
    P = 1, simulation seed = the workload seed."""
    from repro_torch import api, scenarios
    from repro_torch.core import sweep_fabric
    cfg = api.make_config("fifo", n_jobs=n_jobs, n_nodes=n_nodes, seed=0)
    jobsets = [scenarios.build(scenario, dataclasses.replace(cfg, seed=k))
               for k in range(n_seeds)]
    trials = [(js, sv, k) for sv in s_vals for k, js in enumerate(jobsets)]
    table = sweep_fabric.build_table(
        [t[0] for t in trials], np.asarray([t[1] for t in trials],
                                           np.float32), 1,
        np.asarray([t[2] for t in trials], np.uint32))
    return cfg, trials, table


def batched_kernel_vs_plain(torch, np, cfg, table, mode, what):
    """One batched engine run of ``table`` on the card along the kernel
    path and along the plain path (``ops._FORCE_PLAIN``); the two final
    batched States must be equal field for field. Returns the kernel
    path's State (numpy), its stats and the two wall times."""
    from repro_torch.core import sim_batch
    from repro_torch.kernels import ops
    jobs = table.jobs.map(lambda x: x.cuda())
    out = {}
    for path, force in (("kernel", False), ("plain", True)):
        ops._FORCE_PLAIN = force
        try:
            stats = {}
            t0 = time.perf_counter()
            st = sim_batch.run(cfg, jobs, table.s.cuda(), table.P.cuda(),
                               table.seed.cuda(), time_mode=mode,
                               stats=stats)
            torch.cuda.synchronize()
            out[path] = (sim_batch.state_to_numpy(st), stats,
                         time.perf_counter() - t0)
        finally:
            ops._FORCE_PLAIN = False
    (k_st, k_stats, k_s), (p_st, _, p_s) = out["kernel"], out["plain"]
    diff = [f for f in k_st if not np.array_equal(k_st[f], p_st[f])]
    check(not diff, f"{what}: kernel-path batched State differs from the "
          f"plain path in {diff}")
    check(k_stats["launches"] == k_stats["passes"] > 0,
          f"{what}: {k_stats['launches']} launches for "
          f"{k_stats['passes']} passes")
    return k_st, k_stats, k_s, p_s


def lanes_vs_sim_torch(np, cfg, trials, st, stats, mode, policy):
    """Each lane that no draw decided against ``sim_torch.run`` on its
    trial on the card (every State field but the generator and the
    ring; the lane's iteration counts too). Returns the lanes
    compared."""
    from repro_torch.core import sim_batch, sim_torch
    if policy == "rand":
        return 0
    n = 0
    for b, (js, sv, seed) in enumerate(trials):
        if stats["lane_drawn"][b]:
            continue
        c = dataclasses.replace(cfg, policy=policy, s=float(sv),
                                max_preemptions=1)
        one = sim_torch.jobs_from_jobset(js, "cuda")
        sst = {}
        ref = sim_torch.state_to_numpy(sim_torch.run(
            c, one, int(seed), time_mode=mode, stats=sst))
        lane = sim_batch.lane(st, b)
        N = js.n
        got = {k: (v[:N] if np.ndim(v) >= 1 and k not in ("free",
                                                          "pending_free")
                   else v) for k, v in lane.items()}
        diff = [f for f in got if not np.array_equal(got[f], ref[f])]
        check(not diff, f"sweep_engine {policy}/{mode} lane {b}: differs "
              f"from sim_torch.run in {diff}")
        check(stats["lane_iterations"][b] == sst["iterations"]
              and stats["lane_acting"][b] == sst["acting_ticks"],
              f"sweep_engine {policy}/{mode} lane {b}: iteration counts "
              "differ from sim_torch.run")
        n += 1
    return n


def phase_sweep_engine(torch, np):
    """The batched engine's kernel path against its plain path on the
    card, bit for bit on every State field: the JAX sweep selftest's
    grid (burst-storm, 8 nodes, 64 jobs, 3 seeds x s in {0, 2, 4},
    P = 1, one sentinel trial) under every policy in event and tick
    mode; gang-heavy with backfill at 84 nodes, 384 jobs, 2 seeds, under
    every policy in event mode. Each lane that no draw decided is held
    against sim_torch.run on its trial (non-RAND policies)."""
    from repro_torch.core import sweep_fabric
    zero_launches()
    t0 = time.perf_counter()
    runs, compared = [], 0
    for grid, policies, modes, backfill in (
            (SWEEP_ENGINE_GRID, ENGINE_POLICIES, ("event", "tick"), False),
            (SWEEP_ENGINE_GANG, ENGINE_POLICIES, ("event",), True)):
        cfg, trials, table = sweep_table(np, *grid)
        if not backfill:
            table = sweep_fabric.pad_table(table, len(trials) + 1)
        for policy in policies:
            pcfg = dataclasses.replace(cfg, policy=policy,
                                       backfill=backfill)
            for mode in modes:
                what = f"{grid[0]}/{policy}/{mode}"
                st, stats, k_s, p_s = batched_kernel_vs_plain(
                    torch, np, pcfg, table, mode, what)
                n_jobs = st["state"].shape[1]
                if not backfill:      # the sentinel trial never ran
                    check(st["t"][-1] == 0 and stats["lane_iterations"][-1]
                          == 0, f"{what}: the sentinel trial ran")
                check(bool((st["n_done"] == n_jobs).all()),
                      f"{what}: not every trial finished")
                n = lanes_vs_sim_torch(np, pcfg, trials, st, stats, mode,
                                       policy)
                compared += n
                runs.append({
                    "grid": grid[0], "policy": policy, "mode": mode,
                    "backfill": backfill, "trials": int(st["t"].shape[0]),
                    "lanes_vs_sim_torch": n,
                    "preemptions": int(st["preempt_count"].sum()),
                    "fallback_count": st["fallback_count"].tolist(),
                    "iterations": stats["iterations"],
                    "host_reads": stats["host_reads"],
                    "launches": stats["launches"],
                    "kernel_path_s": k_s, "plain_path_s": p_s})
    check(compared > 0, "sweep_engine: no lane was held against sim_torch")
    sharded = sweep_sharded_check(np)
    emit({"phase": "sweep_engine", "equal": True, "cases": len(runs),
          "lanes_vs_sim_torch": compared,
          "seconds": time.perf_counter() - t0, "runs": runs,
          "sharded": sharded})


def sweep_sharded_check(np):
    """SWEEP_SHARDED through ``sharding.trials.ShardPool`` as one shard
    per entry of SWEEP_SHARD_DEVICES (a spawned process each), against
    the one-process ``run_table`` on the card: every per-job stat and
    per-lane counter bit for bit."""
    from repro_torch.core import sweep_fabric
    from repro_torch.sharding import ShardPool
    cfg, _, table = sweep_table(np, *SWEEP_SHARDED)
    cfg = dataclasses.replace(cfg, policy="fitgpp")
    t0 = time.perf_counter()
    one = sweep_fabric.run_table(cfg, table, out="per_job", device="cuda")
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with ShardPool(SWEEP_SHARD_DEVICES) as pool:
        start_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        got = pool.run(cfg, table, out="per_job")
        run_s = time.perf_counter() - t1
    total_s = time.perf_counter() - t0
    diff = [k for k in one.stats
            if not np.array_equal(one.stats[k], got.stats[k], equal_nan=True)]
    diff += [k for k in ("lane_iterations", "lane_acting", "lane_drawn")
             if not np.array_equal(one.engine_stats[k], got.engine_stats[k])]
    check(not diff, f"sweep_engine: the sharded run differs from the "
          f"one-process run in {diff}")
    check(got.n_devices == len(SWEEP_SHARD_DEVICES) and got.n_trials == 4,
          f"sweep_engine: sharded over {got.n_devices} devices")
    return {"grid": SWEEP_SHARDED[0], "nodes": SWEEP_SHARDED[1],
            "jobs": SWEEP_SHARDED[2], "trials": got.n_trials,
            "devices": list(SWEEP_SHARD_DEVICES),
            "n_devices": got.n_devices, "n_padded": got.n_padded,
            "equal": True, "one_process_s": one_s,
            "pool_start_s": start_s, "sharded_run_s": run_s,
            "sharded_total_s": total_s,
            "lane_drawn": one.engine_stats["lane_drawn"].tolist()}


def phase_sweep(torch, np):
    """The slice at full width: Fig. 4 (fitgpp, s in SWEEP_S, P = 1,
    SWEEP_WORKLOADS workloads of SWEEP_JOBS jobs on 84 nodes, event mode) as
    one ``sweep_fabric.run_table(out="per_job")`` on the card, pooled
    per s; the s = 4 lanes held job for job against the port's numpy
    reference engine on the same host (finish ticks through the Eq. 5
    slowdown, preemption counts) wherever neither side drew a used
    fallback. Returns the schedule_step launches of the run."""
    from repro_torch import api
    from repro_torch.core import simulator, sweep_fabric, workload
    from repro_torch.kernels import ops
    cfg = api.make_config("fitgpp", n_jobs=SWEEP_JOBS, n_nodes=PAPER_NODES,
                          seed=0, s=4.0, P=1)
    t0 = time.perf_counter()
    jobsets = [workload.generate(cfg, seed=cfg.seed + 1000 * i)
               for i in range(SWEEP_WORKLOADS)]
    trials = [(sv, i) for sv in SWEEP_S for i in range(SWEEP_WORKLOADS)]
    table = sweep_fabric.build_table(
        [jobsets[i] for _, i in trials],
        np.asarray([sv for sv, _ in trials], np.float32), 1,
        np.full(len(trials), cfg.seed, np.uint32))
    build_s = time.perf_counter() - t0
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sweep_fabric.run_table(cfg, table, out="per_job")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["schedule_step"]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    es = res.engine_stats
    check(launches > 0 and launches == es["launches"] == es["passes"],
          f"sweep: {launches} schedule_step launches for {es['passes']} "
          "passes")
    sd = res.stats["slowdown"]
    check(sd.shape == (len(trials), SWEEP_JOBS)
          and bool(np.isfinite(sd[res.stats["valid"]]).all()),
          "sweep: non-finite or misshapen slowdowns")
    check(bool((res.stats["makespan"] > 0).all()), "sweep: a trial did "
          "not run")
    pooled = {}
    for sv in SWEEP_S:
        cell = sweep_fabric.pooled_tables(
            res, [b for b, (v, _) in enumerate(trials) if v == sv])
        check(all(np.isfinite(v) for c in ("TE", "BE")
                  for v in cell[c].values()), f"sweep s={sv}: non-finite "
              "pooled percentiles")
        pooled[str(sv)] = {"TE_p95": cell["TE"]["p95"],
                           "BE_p50": cell["BE"]["p50"],
                           "preempted_frac": cell["preempted_frac"]}
    # the s = 4 lanes against the numpy reference engine
    ref_s, equal, drawn = [], 0, es["lane_drawn"].tolist()
    c4 = dataclasses.replace(cfg, s=4.0)
    for i, js in enumerate(jobsets):
        b = trials.index((4.0, i))
        t1 = time.perf_counter()
        sim = simulator.Simulator(c4, js)
        ref = sim.run(mode="event")
        ref_s.append(time.perf_counter() - t1)
        if sim.policy.fallback_count or drawn[b]:
            continue
        want = np.float32(1.0) + (ref.finish - ref.submit - ref.exec_total
                                  ).astype(np.float32) \
            / ref.exec_total.astype(np.float32)
        check(np.array_equal(sd[b], want), f"sweep lane {b}: finish ticks "
              "differ from the reference engine's")
        check(np.array_equal(res.stats["preempt_count"][b],
                             ref.preempt_count), f"sweep lane {b}: "
              "preemption counts differ from the reference engine's")
        equal += 1
    emit({"phase": "sweep", "figure": "fig4", "policy": "fitgpp",
          "n_jobs": SWEEP_JOBS, "n_nodes": PAPER_NODES,
          "s_values": list(SWEEP_S), "workloads": SWEEP_WORKLOADS,
          "trials": len(trials), "build_s": build_s, "wall_s": wall,
          "wall_per_trial_s": wall / len(trials),
          "reference_wall_per_trial_s": statistics.mean(ref_s),
          "reference_walls_s": ref_s,
          "iterations": es["iterations"],
          "acting_iterations": es["acting_iterations"],
          "host_reads": es["host_reads"], "launches": launches,
          "reads_per_iteration": es["host_reads"] / es["iterations"],
          "launches_per_iteration": launches / es["iterations"],
          "lane_iterations": es["lane_iterations"].tolist(),
          "lane_drawn": drawn,
          "fallback_count": res.stats["fallback_count"].tolist(),
          "peak_device_gb": peak_gb, "pooled": pooled,
          "s4_lanes_equal_to_reference": equal})
    check(equal > 0, "sweep: no s = 4 lane could be held against the "
          "reference engine")
    return launches


def phase_sweep_b1(torch, np, runs):
    """Not in the default run (``--phases build,paper,sweep_b1``): phase
    paper's fitgpp trial (paper-synthetic, 84 nodes, 2**16 jobs, seed 0,
    event mode) as a one-trial ``sweep_fabric.run_table`` on the card,
    its wall beside phase paper's ``sim_torch`` run of the same trial in
    the same process, and its per-job slowdowns, preemption counts and
    makespan held against that run's where neither drew a random
    fallback. The number that decides whether ``sim_torch`` should
    become the B = 1 case of ``sim_batch``."""
    from repro_torch.core import sweep_fabric
    from repro_torch.kernels import ops
    paper = runs.paper.get("fitgpp")
    check(paper is not None, "sweep_b1: needs phase paper in the same call")
    cfg0, js, _ = runs.jobset(PAPER_JOBS)
    cfg = dataclasses.replace(cfg0, policy="fitgpp")
    table = sweep_fabric.build_table(
        [js], np.asarray([cfg.s], np.float32), cfg.max_preemptions,
        np.asarray([cfg.seed], np.uint32))
    zero_launches()
    t0 = time.perf_counter()
    res = sweep_fabric.run_table(cfg, table, out="per_job")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["schedule_step"]
    es = res.engine_stats
    check(launches > 0 and launches == es["passes"], f"sweep_b1: "
          f"{launches} schedule_step launches for {es['passes']} passes")
    st = paper["state"]
    exact = not es["lane_drawn"][0] and paper["fallback_count"] == 0
    if exact:
        want = np.float32(1.0) + (
            st["finish"].astype(np.int64) - js.submit - js.exec_total
        ).astype(np.float32) / js.exec_total.astype(np.float32)
        check(np.array_equal(res.stats["slowdown"][0], want),
              "sweep_b1: finish ticks differ from phase paper's run")
        check(np.array_equal(res.stats["preempt_count"][0],
                             st["preempt_count"]), "sweep_b1: preemption "
              "counts differ from phase paper's run")
        check(int(res.stats["makespan"][0]) == int(st["t"]), "sweep_b1: "
              "makespan differs from phase paper's run")
    emit({"phase": "sweep_b1", "policy": "fitgpp", "n_jobs": PAPER_JOBS,
          "n_nodes": PAPER_NODES, "wall_s": wall,
          "sim_torch_wall_s": paper["seconds"],
          "sim_batch_over_sim_torch": wall / paper["seconds"],
          "iterations": es["iterations"],
          "acting_iterations": es["acting_iterations"],
          "host_reads": es["host_reads"], "launches": launches,
          "sim_torch_launches": paper["launches"],
          "equal_to_sim_torch": exact})


def flash_flops(shape):
    """The matrix-product FLOPs of one flash-attention call
    (``repro_torch.kernels.flash_attention.flops``: the (query, key)
    pairs its mask attends, 2*hd for q.k and 2*hd for p.v per pair and
    head; the counted work behind a TFLOP/s figure)."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, H, KV, hd, causal, window, _ = shape
    return fa.flops(B, Sq, Skv, H, hd, causal=causal, window=window)


def flash_bound_ms(shape, itemsize):
    """Least time for one flash-attention call: its FLOPs
    (:func:`flash_flops`) over the bf16 tensor-core rate, against q, k,
    v read once and o written once over HBM bandwidth."""
    B, Sq, Skv, H, KV, hd = shape[:6]
    flops = flash_flops(shape)
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
    """The flash kernel against its plain version at FLASH_SHAPES and
    the two serving prefill shapes, each in f32 (the CUDA-core kernel)
    and bf16 (the wgmma kernel), then timed at the serving shapes in
    bf16 beside the plain version and PyTorch's
    scaled_dot_product_attention (a yardstick the port never calls),
    with the counted TFLOP/s."""
    from repro_torch.kernels import flash_attention as fa
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    cases = [(s, d) for s in FLASH_SHAPES + [FLASH_MAIN_SHAPE,
                                             FLASH_WINDOW_SHAPE]
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
    del q, k, v, qt, kt, vt
    window = flash_window_timing(torch, fa)
    model_shapes = {arch: flash_model_shape_case(torch, fa, shape, 200 + i)
                    for i, (arch, shape) in
                    enumerate(FLASH_MODEL_SHAPES.items())}
    max_row_err = max([max_row_err] + [c["max_row_rel_err"]
                                       for c in model_shapes.values()])
    max_err["bfloat16"] = max([max_err["bfloat16"]]
                              + [c["max_abs_err"]
                                 for c in model_shapes.values()])
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
          "library_max_abs_err_vs_plain": lib_err, "window_case": window,
          "model_shapes": model_shapes,
          "tflops_counted": flash_flops(shape) / ms / 1e9, **result})
    result.update({f"window_{k}": window[k] for k in
                   ("ms", "plain_ms", "bound_ms", "library_ms")})
    return result


def flash_window_timing(torch, fa):
    """The flash kernel's window path at the recurrentgemma prefill
    shape (bf16): its time, the plain version's, the bound, and
    scaled_dot_product_attention with the same mask as a yardstick."""
    shape = FLASH_WINDOW_SHAPE
    window = shape[7]
    q, k, v = flash_inputs(torch, shape, torch.bfloat16, 101)
    ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v,
                                                        window=window))
    plain_ms = time_ms(torch, lambda: fa.flash_attention_torch(
        q, k, v, window=window))
    mask = fa._attention_mask(shape[1], shape[2], causal=True,
                              window=window, device="cuda")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(torch, lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             qt, kt, vt, attn_mask=mask, enable_gqa=True))
    bound, bound_by = flash_bound_ms(shape, 2)
    del q, k, v, qt, kt, vt
    free_cuda(torch)
    return {"shape": dict(zip(("B", "Sq", "Skv", "H", "KV", "hd", "causal",
                                "window"), shape[:8]), dtype="bfloat16"),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": library_ms,
            "tflops_counted": flash_flops(shape) / ms / 1e9,
            "library_call": "scaled_dot_product_attention(attn_mask=window "
                            "mask, enable_gqa=True)"}


def flash_model_shape_case(torch, fa, shape, seed):
    """The flash kernel at a new family's prefill shape (bf16): held
    against its plain version, 1024 queries at a time (query i of a
    chunk ending at c1 sits at position c1 - 1024 + i over the first c1
    keys; the whole f32 score tensor at mixtral's shape would be 13 GB),
    elementwise (FLASH_TOL) and per row (FLASH_BF16_ROW_TOL); then
    timed beside scaled_dot_product_attention with the same mask, and
    the bound."""
    B, Sq, Skv, H, KV, hd, causal, window, cap = shape
    q, k, v = flash_inputs(torch, shape, torch.bfloat16, seed)
    out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                  softcap=cap)
    tol, err, row_err = FLASH_TOL["bfloat16"], 0.0, 0.0
    for c0 in range(0, Sq, 1024):
        c1 = min(c0 + 1024, Sq)
        ref = fa.flash_attention_torch(q[:, c0:c1], k[:, :c1], v[:, :c1],
                                       causal=causal, window=window,
                                       softcap=cap)
        got = out[:, c0:c1]
        diff = (got.float() - ref.float()).abs()
        check(bool((diff <= tol + tol * ref.float().abs()).all()),
              f"flash_attention differs from the plain version at {shape} "
              f"bf16 (queries {c0}..{c1}): max abs err {float(diff.max())}")
        err = max(err, float(diff.max()))
        row_err = max(row_err, row_rel_err(got, ref))
        del ref, got, diff
    check(row_err <= FLASH_BF16_ROW_TOL, f"flash_attention differs from the "
          f"plain version at {shape} bf16 by {row_err} of a row's max")
    del out
    ms = time_ms(torch, lambda: fa.flash_attention_cuda(
        q, k, v, causal=causal, window=window, softcap=cap))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window:
        mask = fa._attention_mask(Sq, Skv, causal=True, window=window,
                                  device="cuda")
        kw, call = {"attn_mask": mask}, "attn_mask=window mask"
    else:
        kw, call = {"is_causal": True}, "is_causal=True"
    library_ms = time_ms(torch, lambda: torch.nn.functional
                         .scaled_dot_product_attention(qt, kt, vt,
                                                       enable_gqa=True, **kw))
    bound, bound_by = flash_bound_ms(shape, 2)
    del q, k, v, qt, kt, vt, kw
    free_cuda(torch)
    return {"shape": dict(zip(("B", "Sq", "Skv", "H", "KV", "hd", "causal",
                                "window"), shape[:8]), dtype="bfloat16"),
            "max_abs_err": err, "max_row_rel_err": row_err, "ms": ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_call": f"scaled_dot_product_attention({call}, "
                            "enable_gqa=True)",
            "tflops_counted": flash_flops(shape) / ms / 1e9}


# ssd_chunk: the JAX suite's shapes (tests/test_kernels.py, TestSsdChunk-
# Kernel and its ssd_scan case), a ragged and a multi-chunk case, each
# in f32 and bf16, (B, L, H, P, N, groups); groups > 0 passes Bm/Cm as
# an expand()ed view of that many groups (stride 0 across the heads of
# a group, as ssd_scan passes them)
SSD_SHAPES = [
    (2, 256, 2, 64, 32, 0), (1, 512, 4, 64, 128, 0), (2, 128, 2, 32, 16, 0),
    (1, 64, 2, 16, 8, 0),
    (2, 300, 3, 24, 20, 0),          # ragged: a 44-row last chunk, P, N odd
    (1, 100, 2, 40, 12, 1),          # one short chunk (Q = L = 100)
    (1, 1024, 4, 64, 64, 1),         # 4 chunks, heads broadcast from 1 group
]
# the mamba2-1.3b prefill as ssd_scan hands it to the kernel: the
# (B*c, q, H, .) view of B 4, L 2048 in chunks of 256, f32 operands,
# Bm/Cm broadcast from one group
SSM_ARCH = "mamba2-1.3b"
SSD_MAIN_SHAPE = (4 * 2048 // 256, 256, 64, 64, 128, 1)
SCAN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# lru_scan: the JAX suite's shapes (TestLruScan), each in f32 and bf16,
# then the recurrentgemma-9b prefill shape, with and without h0, a
# ragged one (R 4001: the simple route) and the tma route's ragged L,
# (B, L, R, h0). The kernel's route follows from R, the type and the
# alignment (lru_scan._route): R 130 in f32 and R 4001 take the simple
# route, the rest the tma route.
LRU_SHAPES = [(2, 256, 512, False), (2, 300, 130, True),
              (1, 64, 1024, True), (3, 1024, 64, False)]
HYBRID_ARCH = "recurrentgemma-9b"
LRU_MAIN_SHAPE = (4, 4096, 4096, False)
LRU_RAGGED_L = (1, 4099, 4096, True)
LRU_SIMPLE_SHAPE = (3, 4099, 4001, True)
LRU_MAIN_CASES = [LRU_MAIN_SHAPE, (4, 4096, 4096, True), LRU_SIMPLE_SHAPE,
                  LRU_RAGGED_L]
# lru_scan's backward (``LruScan``): the gradients held against autograd
# through the plain version on the card at the JAX suite's shapes, a
# ragged one, and phase train_hybrid's shape (1 x 4096 tokens, lru width
# 4096, no h0), f32. Bit-equality is expected: the reverse launch and
# autograd do the same IEEE multiply and add per step (which commute),
# and each of da, db, dh0 is one product or a copy; SCAN_TOL's f32 1e-4
# is checked as well. The reverse launch is timed at the training shape.
LRU_TRAIN_SHAPE = (1, 4096, 4096, False)
LRU_GRAD_CASES = LRU_SHAPES + [LRU_SIMPLE_SHAPE, LRU_RAGGED_L,
                               LRU_TRAIN_SHAPE]


def check_close(torch, name, got, want, tol):
    """|got - want| <= tol + tol * |want| elementwise (the JAX suite's
    assert_allclose with atol = rtol = tol); returns max|got - want|."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name}: {got.dtype}{tuple(got.shape)} vs plain "
          f"{want.dtype}{tuple(want.shape)}")
    d = (got.float() - want.float()).abs()
    err = float(d.max()) if d.numel() else 0.0
    check(bool((d <= tol + tol * want.float().abs()).all()),
          f"{name} differs from the plain version: max abs err {err} "
          f"(tolerance {tol})")
    return err


def unique_bytes(t):
    """Bytes of the distinct elements a (possibly expanded) tensor
    addresses: axes of stride 0 count once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def ssd_inputs(torch, shape, dtype, seed):
    """xdt, loga, Bm, Cm like the JAX suite's (0.3 * normal, -softplus
    of a normal), Bm/Cm as an expanded view of ``groups`` groups when
    groups > 0."""
    B, L, H, P, N, groups = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(*s):
        return torch.randn(s, generator=gen, device="cuda")

    G = groups or H
    xdt = (rnd(B, L, H, P) * 0.3).to(dtype)
    loga = (-torch.nn.functional.softplus(rnd(B, L, H))).to(dtype)
    bc = [(rnd(B, L, G, N) * 0.3).to(dtype) for _ in range(2)]
    if groups:
        bc = [m.repeat_interleave(H // G, dim=2) if G > 1 else
              m.expand(B, L, H, N) for m in bc]
    return xdt, loga, bc[0], bc[1]


def ssd_bound_ms(shape, args, out_itemsize, peak, passes=1):
    """Least time for one ssd_chunk call: the causal half of the work
    (per (b, h) and query i of a chunk, i + 1 keys, each a score of N
    multiply-adds and a weighted sum of P), taken ``passes`` times (3
    for the 3xTF32 route in f32), over ``peak``, against the inputs'
    distinct bytes read once and y written once over HBM bandwidth.
    The count is ``repro_torch.kernels.ssd_chunk.flops``."""
    from repro_torch.kernels import ssd_chunk as sc
    B, L, H, P, N, _ = shape
    flops = sc.flops(B, L, H, P, N) * passes
    nbytes = sum(unique_bytes(t) for t in args) + B * L * H * P * out_itemsize
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_ssd_kernel(torch):
    """The ssd_chunk kernel against its plain version at the JAX suite's
    shapes, a ragged and a multi-chunk case and the mamba2 prefill
    shape, f32 (1e-4) and bf16 (5e-2), then timed at the latter. The
    kernel runs both products as 3xTF32 wgmma, so its bound is taken on
    that route (three TF32 products at the TF32 rate); the bound of the
    f32 CUDA-core route is reported beside it."""
    from repro_torch.kernels import ssd_chunk as sc
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    cases = [(s, d) for s in SSD_SHAPES + [SSD_MAIN_SHAPE] for d in dtypes]
    max_err = {}
    for seed, (shape, dname) in enumerate(cases):
        args = ssd_inputs(torch, shape, dtypes[dname], seed)
        out = sc.ssd_chunk_cuda(*args)
        ref = sc.ssd_chunk_torch(*args)
        torch.cuda.synchronize()
        err = check_close(torch, f"ssd_chunk {shape} {dname}", out, ref,
                          SCAN_TOL[dname])
        max_err[dname] = max(max_err.get(dname, 0.0), err)
        del args, out, ref
    shape = SSD_MAIN_SHAPE
    args = ssd_inputs(torch, shape, torch.float32, 100)
    ms = time_ms(torch, lambda: sc.ssd_chunk_cuda(*args))
    plain_ms = time_ms(torch, lambda: sc.ssd_chunk_torch(*args))
    bound, bound_by = ssd_bound_ms(shape, args, 4, PEAK_TF32_PER_S, 3)
    f32_bound, f32_bound_by = ssd_bound_ms(shape, args, 4, PEAK_F32_PER_S)
    result = {"name": "ssd_chunk", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
              "replaces": "src/repro/kernels/ssd_chunk.py:71",
              "max_abs_err": max(max_err.values()), "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
              "library_ms": None}
    emit({"phase": "ssd_kernel", "cases": len(cases),
          "max_abs_err_by_dtype": max_err, "tolerance": SCAN_TOL,
          "timed_shape": dict(zip(("B", "L", "H", "P", "N", "groups"),
                                  shape), dtype="float32", Q=256),
          "library_call": "none: no single PyTorch call computes it",
          "bound_route": "3xTF32 wgmma: three TF32 products at 495 TFLOP/s",
          "f32_cuda_core_bound_ms": f32_bound,
          "f32_cuda_core_bound_by": f32_bound_by, **result})
    del args
    return result


def lru_inputs(torch, shape, dtype, seed):
    """a = sigmoid(normal), b = 0.5 * normal, h0 normal (the JAX
    suite's draws)."""
    B, L, R, with_h0 = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    a = torch.sigmoid(torch.randn((B, L, R), generator=gen, device="cuda"))
    b = torch.randn((B, L, R), generator=gen, device="cuda") * 0.5
    h0 = torch.randn((B, R), generator=gen, device="cuda").to(dtype) \
        if with_h0 else None
    return a.to(dtype), b.to(dtype), h0


def lru_bound_ms(shape, itemsize):
    """Least time for one lru_scan call: a and b read and h written once
    (and h0 read) over HBM bandwidth, against a multiply and an add per
    element over the f32 rate."""
    B, L, R, with_h0 = shape
    nbytes = 3 * B * L * R * itemsize + (4 * B * R if with_h0 else 0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * B * L * R / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lru_route(ls, a, b, out):
    """The route ``lru_scan_cuda`` took for these tensors."""
    return ls._route(a.shape[2], a.dtype, a.data_ptr(), b.data_ptr(),
                     out.data_ptr())


def phase_lru_kernel(torch):
    """The lru_scan kernel against its plain version at the JAX suite's
    shapes (f32 1e-4, bf16 5e-2, and bit for bit) and at the
    recurrentgemma prefill shape, with and without h0, and ragged ones
    (f32), each with the route it took; then timed: the f32 forward at
    the prefill shape without h0 (as the prefill calls it) and at the
    training shape, the bf16 forward at the prefill shape, and the
    simple route at its ragged shape, each beside its bound and each
    timed input's output held against the plain version as well."""
    from repro_torch.kernels import lru_scan as ls
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    cases = [(s, d) for s in LRU_SHAPES for d in dtypes] \
        + [(s, "float32") for s in LRU_MAIN_CASES]
    max_err, exact, routes = {}, True, []
    for seed, (shape, dname) in enumerate(cases):
        a, b, h0 = lru_inputs(torch, shape, dtypes[dname], seed)
        out = ls.lru_scan_cuda(a, b, h0)
        ref = ls.lru_scan_torch(a, b, h0)
        torch.cuda.synchronize()
        err = check_close(torch, f"lru_scan {shape} {dname}", out, ref,
                          SCAN_TOL[dname])
        same = bool(torch.equal(out, ref))
        exact = exact and same
        routes.append({"shape": list(shape), "dtype": dname,
                       "route": lru_route(ls, a, b, out), "bit_equal": same})
        max_err[dname] = max(max_err.get(dname, 0.0), err)
        del a, b, h0, out, ref
    timed = {}
    for key, shape, dname in (("prefill", LRU_MAIN_SHAPE, "float32"),
                              ("train", LRU_TRAIN_SHAPE, "float32"),
                              ("prefill_bf16", LRU_MAIN_SHAPE, "bfloat16"),
                              ("simple", LRU_SIMPLE_SHAPE, "float32")):
        a, b, h0 = lru_inputs(torch, shape, dtypes[dname], 100)
        out = ls.lru_scan_cuda(a, b, h0)
        ref = ls.lru_scan_torch(a, b, h0)
        torch.cuda.synchronize()
        err = check_close(torch, f"lru_scan timed {shape} {dname}", out,
                          ref, SCAN_TOL[dname])
        max_err[dname] = max(max_err[dname], err)
        same = bool(torch.equal(out, ref))
        exact = exact and same
        bound, bound_by = lru_bound_ms(shape, a.element_size())
        timed[key] = {"shape": list(shape), "dtype": dname,
                      "route": lru_route(ls, a, b, out), "bit_equal": same,
                      "ms": time_ms(torch, lambda: ls.lru_scan_cuda(a, b, h0)),
                      "bound_ms": bound, "bound_by": bound_by}
        if key == "prefill":
            plain_ms = time_ms(torch, lambda: ls.lru_scan_torch(a, b),
                               reps=5)
        del a, b, h0, out, ref
    backward = lru_backward_checks(torch, ls)
    main = timed["prefill"]
    result = {"name": "lru_scan", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/lru_scan.cu",
              "replaces": "src/repro/kernels/lru_scan.py:59",
              "max_abs_err": max(max_err.values()), "ms": main["ms"],
              "plain_ms": plain_ms, "bound_ms": main["bound_ms"],
              "bound_by": main["bound_by"], "library_ms": None,
              "backward_ms": backward["ms"],
              "backward_bound_ms": backward["bound_ms"],
              "backward_shape": backward["shape"]}
    emit({"phase": "lru_kernel", "cases": len(cases),
          "max_abs_err_by_dtype": max_err, "tolerance": SCAN_TOL,
          "bit_equal_all_cases": exact and backward["bit_equal_all_cases"],
          "forward_bit_equal_all_cases": exact,
          "routes": routes, "timed": timed,
          "timed_shape": dict(zip(("B", "L", "R"), LRU_MAIN_SHAPE[:3]),
                              dtype="float32", h0=False),
          "plain_reps": 5,
          "library_call": "none: no single PyTorch call computes it",
          "backward": backward, **result})
    check(exact and backward["bit_equal_all_cases"],
          "lru_scan differs from its plain version in some bit")
    check({r["route"] for r in routes} == {"tma", "simple"},
          "lru_scan's checked cases did not take both routes")
    return result


def lru_backward_checks(torch, ls):
    """``LruScan``'s gradients (da, db, dh0) against autograd through
    ``lru_scan_torch`` on the card at LRU_GRAD_CASES, with the launches
    each takes (one forward, one reverse) and the reverse launch's
    route; then the reverse launch timed at LRU_TRAIN_SHAPE, queued as
    the forward is, beside its bound (a and the upstream gradient read,
    lam written once)."""
    max_err, exact, launches, routes = 0.0, True, set(), []
    for seed, shape in enumerate(LRU_GRAD_CASES):
        a, b, h0 = lru_inputs(torch, shape, torch.float32, 200 + seed)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(300 + seed)
        g = torch.randn(a.shape, generator=gen, device="cuda")
        grads = []
        for kernel, fn in ((True, ls.LruScan.apply),
                           (False, ls.lru_scan_torch)):
            ins = [x.clone().requires_grad_(True) for x in (a, b, h0)
                   if x is not None]
            before = ls.build.LAUNCHES["lru_scan"]
            out = fn(*ins, *([] if h0 is not None else [None]))
            grads.append(torch.autograd.grad(out, ins, g))
            if kernel:
                launches.add(ls.build.LAUNCHES["lru_scan"] - before)
            del out, ins
        torch.cuda.synchronize()
        same = True
        for got, want in zip(*grads):
            max_err = max(max_err, check_close(
                torch, f"lru_scan backward {shape}", got, want,
                SCAN_TOL["float32"]))
            same = same and bool(torch.equal(got, want))
        exact = exact and same
        # the reverse launch reads a and g and writes a fresh lam
        routes.append({"shape": list(shape),
                       "route": lru_route(ls, a, g, grads[0][1]),
                       "bit_equal": same})
        del a, b, h0, g, grads
    check(launches == {2}, f"LruScan took {sorted(launches)} launches for "
          "a forward and a backward, not 2")
    B, L, R, _ = LRU_TRAIN_SHAPE
    a, _, _ = lru_inputs(torch, LRU_TRAIN_SHAPE, torch.float32, 400)
    g = torch.randn_like(a)
    ms = time_ms(torch, lambda: ls.lru_scan_reverse_cuda(a, g))
    nbytes = 3 * B * L * R * 4
    del a, g
    return {"cases": len(LRU_GRAD_CASES), "max_abs_err": max_err,
            "bit_equal_all_cases": exact, "tolerance": SCAN_TOL["float32"],
            "routes": routes, "launches_per_call": 2, "shape": [B, L, R],
            "ms": ms, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


# kernel-name fragments of the matrix products (cuBLAS/CUTLASS on Hopper)
MATMUL_KERNELS = ("gemm", "nvjet", "xmma", "cutlass", "cublas", "sm90_")
# the port's kernels on the serving paths, by a fragment of their names
PORT_KERNELS = {"flash_attention": "flash_fwd_kernel",
                "ssd_chunk": "ssd_chunk_kernel", "lru_scan": "lru_scan_kernel"}


def device_breakdown(torch, fn):
    """Run ``fn`` once under ``torch.profiler`` and split the device
    time of its kernels by name: matrix products, each of the port's
    serving kernels (and its ``_share`` of the device time), everything
    else; ``idle_share`` is 1 - device time
    / host wall time (the profiler's own overhead falls in the wall
    time). Returns None when the profiler shows no device time."""
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
    split = {"matmul_ms": 0.0, **{f"{k}_ms": 0.0 for k in PORT_KERNELS},
             "other_ms": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        key = next((f"{k}_ms" for k, frag in PORT_KERNELS.items()
                    if frag in name), None) \
            or ("matmul_ms" if any(f in low for f in MATMUL_KERNELS)
                else "other_ms")
        split[key] += ms
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    shares = {f"{k}_share": split[f"{k}_ms"] / device_ms
              for k in PORT_KERNELS if split[f"{k}_ms"] > 0}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_kernels": n_kernels, **split, **shares,
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
    serve.serve(cfg, model, {"tokens": prompt[:, :128]}, 2)   # warm-up
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    res = serve.serve(cfg, model, {"tokens": prompt}, SERVE_STEPS)
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
        res = serve.serve(cfg, model, {"tokens": prompt}, SERVE_STEPS)
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
    res = serve.serve(cfg, card_model, {"tokens": prompt.cuda()}, 8)
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


# SSM and hybrid serving: batch 4, 32 greedy decode steps after a
# prompt of 2048 (mamba2) or 4096 tokens (recurrentgemma: twice its
# 2048-token window, so the window masks keys in every attention layer
# and the prefill's ring re-pack keeps the last 2048)
FAMILY_PROMPT = {SSM_ARCH: 2048, HYBRID_ARCH: 4096}
# kernel launches per prefill: one ssd_chunk per mamba2 layer; one
# lru_scan per recurrent and one flash_attention per attention layer
FAMILY_LAUNCHES = {SSM_ARCH: {"ssd_chunk": 48},
                   HYBRID_ARCH: {"lru_scan": 26, "flash_attention": 12}}
# Serving agreement of the recurrent families in bf16, max|logits -
# reference| over max|reference|, against two references on the same
# weights and tokens:
# - the plain path's own serving run (prefill, then serve_step fed the
#   served tokens, every kernel replaced by its plain version): the
#   same operations at the same rounding points except inside the
#   kernels: lru_scan agrees with its plain version bit for bit, flash
#   rounds p at other points, and ssd_chunk's 3xTF32 products sum in
#   another order and keep about 21 bits of each operand, so its f32 y
#   lies within SSD_ROW_TOL of a row's max from the plain y, and mostly
#   within a few 1e-6 of it. Such a difference moves the bf16 rounding
#   after ssd_scan only where y sits that close to a rounding boundary,
#   one bf16 step (2^-8) there, and such steps compound through the
#   layers as flash's do in stablelm's 40, which stay within
#   SERVE_BF16_TOL;
# - the plain full forward over prompt + fed tokens. A decode step
#   rounds to bf16 where the chunked full sequence does not (the
#   recurrent state kept in bf16 and re-rounded every step, as in the
#   JAX package; the four conv taps summed in one product where the
#   full sequence rounds after each; one-row matmuls), so each layer's
#   mixer output lands one or two bf16 steps (2^-8, 2^-7) from the full
#   forward's, independently per layer: over L layers about
#   sqrt(L) * 2^-8 of the residual stream, 2.7e-2 at mamba2's 48 layers
#   and 2.4e-2 at recurrentgemma's 38, which the logits inherit. The
#   bound is 4 times that for mamba2 (1e-1) and 2 times for
#   recurrentgemma, whose embedding (scaled by sqrt(d_model)) dominates
#   the stream (5e-2).
FORWARD_BF16_TOL = {SSM_ARCH: 1e-1, HYBRID_ARCH: 5e-2}
# full width, cut depth, float32 (TF32 off): recurrentgemma keeps one
# full (rec, rec, attn) group
FAMILY_F32_LAYERS = {SSM_ARCH: 2, HYBRID_ARCH: 3}
# Each layer's kernel output against its plain version on the same
# inputs, per row (max|delta| over the row's max|plain|). lru_scan gets
# float32 operands and gives float32 (the RG-LRU casts first, as the
# JAX package does) and agrees bit for bit; flash follows
# FLASH_BF16_ROW_TOL in bf16 and the scans' float32 tolerance in
# float32.
KERNEL_ROW_TOL = {"float32": 1e-4, "bfloat16": FLASH_BF16_ROW_TOL}
# ssd_chunk gets float32 operands too (ssd_scan casts first) but runs
# its products as 3xTF32, which keeps about 21 bits of each operand
# where float32 keeps 24, and sums in another order. A row whose terms
# cancel, a chunk's first query y_0 = (C_0 . B_0) x_0 with a small
# C_0 . B_0, then carries that residual over a small row max: the
# float32 plain version itself lies 1.13e-4 of a row's max from the
# float64 result there, so no kernel that is not bit-equal to it can
# hold 1e-4. The row limit is the geometric mean of two readings at the
# serve_ssm shapes (H100): the kernel's largest row error, 1.40e-4, and
# that of a single-TF32 control put in its place (ssd_chunk_one_tf32),
# 1.82e-3, which must fail the same check (phase serve_ssm runs both).
SSD_ROW_TOL = 5e-4


def layer_row_tol(name, dtype):
    return SSD_ROW_TOL if name == "ssd_chunk" else KERNEL_ROW_TOL[dtype]


def tf32_rna(torch, x):
    """float32 rounded to TF32 (10 mantissa bits, ties away from zero),
    as cvt.rna.tf32.f32 rounds it; finite inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def ssd_chunk_one_tf32(torch, xdt, loga, Bm, Cm):
    """The row check's control: ssd_chunk with each product operand (C,
    B, the decay-weighted scores W and x) rounded once to TF32, as a
    single TF32 tensor-core pass takes it, float32 sums (TF32 off in
    the products themselves); y in xdt's type. L a multiple of the
    chunk."""
    from repro_torch.kernels import ssd_chunk as sc
    B, L, H, P = xdt.shape
    Q = min(sc.CHUNK, L)
    check(L % Q == 0, "the control takes whole chunks")
    x, lg, bm, cm = (t.float().reshape(B * (L // Q), Q, *t.shape[2:])
                     for t in (xdt, loga, Bm, Cm))
    z = torch.cumsum(lg, dim=1)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(causal[None, :, :, None],
                        torch.exp(z[:, :, None, :] - z[:, None, :, :]), 0.0)
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        s_ = torch.einsum("bqhn,bshn->bqsh", tf32_rna(torch, cm),
                          tf32_rna(torch, bm))
        y = torch.einsum("bqsh,bshp->bqhp", tf32_rna(torch, s_ * decay),
                         tf32_rna(torch, x))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep
    return y.reshape(B, L, H, P).to(xdt.dtype)


def ssd_chunk_f64(torch, xdt, loga, Bm, Cm):
    """ssd_chunk's plain computation in float64, the rows' exact
    reference; L a multiple of the chunk."""
    from repro_torch.kernels import ssd_chunk as sc
    B, L, H, P = xdt.shape
    Q = min(sc.CHUNK, L)
    check(L % Q == 0, "the float64 reference takes whole chunks")
    x, lg, bm, cm = (t.double().reshape(B * (L // Q), Q, *t.shape[2:])
                     for t in (xdt, loga, Bm, Cm))
    return sc._chunks_torch(x, lg, bm, cm).reshape(B, L, H, P)


def plain_kernel_checks(torch):
    """(owner, attribute, label, plain version, when) of each serving
    kernel: the function a model calls through ``owner.attribute``, what
    computes it without the kernel on the same arguments, and which
    calls reach the kernel (attention: a prompt with the kernel hint;
    whisper's encoder and cross-attention pass none)."""
    from repro_torch.kernels import lru_scan as ls
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models import attention
    attend = attention.attend

    def plain_attend(q, k, v, **kw):
        ops._FORCE_PLAIN = True
        try:
            return attend(q, k, v, **kw)
        finally:
            ops._FORCE_PLAIN = False

    return [(ops, "ssd_chunk", "ssd_chunk", sc.ssd_chunk_torch, None),
            (ops, "lru_scan", "lru_scan", ls.lru_scan_torch, None),
            (attention, "attend", "flash_attention", plain_attend,
             lambda q, *a, **kw: q.shape[1] > 1
             and kw.get("causal") is not None)]


class HeldAgainstPlain:
    """While active, every call of a serving kernel's entry point is
    also computed by its plain version on the same arguments, and the
    per-row error (:func:`row_rel_err`) is kept by kernel name; the
    kernel's output is what the model goes on with. ``replace`` ({name:
    fn}) puts ``fn`` in a kernel's place (a control); ``exact`` ({name:
    fn}) also keeps, per call, the row errors of the output and of the
    plain version against ``fn``'s float64 result."""

    def __init__(self, torch, replace=None, exact=None):
        self.checks = plain_kernel_checks(torch)
        self.errs = {label: [] for _, _, label, _, _ in self.checks}
        self.replace = replace or {}
        self.exact = exact or {}
        self.exact_errs = {label: [] for label in self.exact}
        self.saved = []

    def __enter__(self):
        for owner, attr, label, plain, when in self.checks:
            orig = getattr(owner, attr)

            def checking(*args, _orig=orig, _label=label, _plain=plain,
                         _when=when, **kw):
                out = self.replace.get(_label, _orig)(*args, **kw)
                if _when is None or _when(*args, **kw):
                    want = _plain(*args, **kw)
                    self.errs[_label].append(
                        (row_rel_err(out, want),
                         str(out.dtype).replace("torch.", "")))
                    if _label in self.exact:
                        ref = self.exact[_label](*args, **kw)
                        self.exact_errs[_label].append(
                            (row_rel_err(out, ref), row_rel_err(want, ref)))
                return out

            self.saved.append((owner, attr, orig))
            setattr(owner, attr, checking)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self.saved):
            setattr(owner, attr, orig)
        self.saved.clear()

    def report(self, want):
        """Check each kernel of ``want`` ({name: calls}) was held once
        per call and within its row limit (:func:`layer_row_tol`);
        returns {name: max err}."""
        out = {}
        for name, n in want.items():
            errs = self.errs[name]
            check(len(errs) == n, f"{name} held against its plain version "
                  f"{len(errs)} times, not {n}")
            for err, dtype in errs:
                tol = layer_row_tol(name, dtype)
                check(err <= tol, f"a layer's {name} output differs from "
                      f"its plain version by {err} of a row's max "
                      f"(tolerance {tol}, {dtype})")
            out[name] = max(e for e, _ in errs)
        return out

    def exact_report(self):
        """{name: {"served_vs_f64", "plain_vs_f64"}}: the largest row
        errors against the float64 results over the held calls."""
        return {name: {"served_vs_f64": max(a for a, _ in errs),
                       "plain_vs_f64": max(b for _, b in errs)}
                for name, errs in self.exact_errs.items() if errs}


def ssd_row_control(torch, cfg, model, prompt, n_calls):
    """One more prefill with the single-TF32 control in ssd_chunk's
    place (:func:`ssd_chunk_one_tf32`), held against the plain version
    as the kernel is: the harness's row check must fail it, or it could
    not tell a single TF32 pass from the kernel's three. Returns the
    control's largest row error and the limit it exceeds."""
    from repro_torch import models
    one_pass = {"ssd_chunk": lambda *a, **kw: ssd_chunk_one_tf32(
        torch, *a, **kw)}
    with HeldAgainstPlain(torch, replace=one_pass) as ctl:
        models.prefill(cfg, model, {"tokens": prompt})
    errs = ctl.errs["ssd_chunk"]
    check(len(errs) == n_calls, f"the control was held {len(errs)} times, "
          f"not {n_calls}")
    try:
        ctl.report({"ssd_chunk": n_calls})
    except SmokeFailure:
        pass
    else:
        check(False, f"the single-TF32 control passed the ssd_chunk row "
              f"check (limit {SSD_ROW_TOL}): the check cannot tell it "
              f"from the kernel")
    return {"max_row_rel_err": max(e for e, _ in errs),
            "limit": SSD_ROW_TOL, "failed_the_check": True}


def family_launches(cfg):
    """{kernel: launches} of one prefill of ``cfg``."""
    if cfg.family == "ssm":
        return {"ssd_chunk": cfg.n_layers}
    from repro_torch.models import hybrid
    _, _, n_rec, n_attn = hybrid.layer_layout(cfg)
    return {"lru_scan": n_rec, "flash_attention": n_attn}


def zero_launches():
    from repro_torch.kernels import ops
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0


def check_launches(launches, want, where):
    for name, n in launches.items():
        check(n == want.get(name, 0), f"{where} launched {name} {n} times, "
              f"not {want.get(name, 0)}")


def tail_reference_logits(torch, cfg, model, prompt, fed):
    """The plain path's full forward (no kernel) over prompt + fed
    tokens, unembedding only the positions the serving run produced
    (the last prompt token, then each fed one): the logits of every
    position of recurrentgemma's 256,000-token vocabulary would take
    8.5 GB in bf16."""
    from repro_torch import models
    from repro_torch.kernels import ops
    from repro_torch.models import dense
    tokens = torch.cat([prompt, fed], dim=1)
    ops._FORCE_PLAIN = True
    try:
        with torch.no_grad():
            x = models.get_module(cfg).hidden(cfg, model, tokens)
            return dense.unembed(cfg, model, x[:, prompt.shape[1] - 1:])
    finally:
        ops._FORCE_PLAIN = False


def plain_served_logits(torch, cfg, model, batch, fed):
    """The plain path's serving run on the same weights: ``batch``
    (``make_batch``'s dict) prefilled with room for ``fed`` (B, n), then
    serve_step fed it one token at a time, every kernel replaced by its
    plain version; the logits at the served positions (the prefill's
    last, then each step's)."""
    from repro_torch import models
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops._FORCE_PLAIN = True
    try:
        logits, cache = models.prefill(
            cfg, model, batch,
            pad_to=serve.prompt_positions(cfg, batch) + fed.shape[1])
        out = [logits]
        for i in range(fed.shape[1]):
            step, cache = models.serve_step(cfg, model, cache,
                                            fed[:, i:i + 1])
            out.append(step)
    finally:
        ops._FORCE_PLAIN = False
    return torch.cat(out, dim=1)


def phase_serve_family(torch, arch):
    """A serving main path: ``arch`` at its full config, bf16, random
    weights from seed 0, Zipf prompts from seed 0; a batch of 4 prompts
    through the prefill (its kernels launched FAMILY_LAUNCHES times,
    none in decode), 32 greedy decode steps; each layer's kernel output
    held against its plain version on the same inputs, and the logits
    against the plain path's full forward over the same tokens."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = get_config(arch)
    prompt_len, want = FAMILY_PROMPT[arch], FAMILY_LAUNCHES[arch]
    check(family_launches(cfg) == want, f"{arch}: layer layout "
          f"{family_launches(cfg)} is not {want}")
    t0 = time.perf_counter()
    model = models.init(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = make_batch(cfg, SERVE_BATCH, prompt_len, 0, 0,
                        device="cuda")["tokens"]
    serve.serve(cfg, model, {"tokens": prompt[:, :256]}, 2)   # warm-up
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    res = serve.serve(cfg, model, {"tokens": prompt}, SERVE_STEPS)
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_launches(launches, want, f"serving {arch}")
    # one more decode step launches no kernel
    models.serve_step(cfg, model, res.cache, res.tokens[:, -1:])
    check_launches(dict(ops.LAUNCHES), want, f"{arch} decode")
    check(tuple(res.tokens.shape) == (SERVE_BATCH, SERVE_STEPS + 1),
          "bad token shape")
    got = served_logits(torch, res)
    check(bool(torch.isfinite(got).all()), f"non-finite {arch} logits")
    res.cache.clear()
    free_cuda(torch)
    state = {}

    def prefill():
        state["logits"], state["cache"] = models.prefill(
            cfg, model, {"tokens": prompt})

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
    exact = {"ssd_chunk": lambda *a, **kw: ssd_chunk_f64(torch, *a, **kw)} \
        if "ssd_chunk" in want else None
    with HeldAgainstPlain(torch, exact=exact) as held:
        models.prefill(cfg, model, {"tokens": prompt})
    layer_errs = held.report(want)
    layer_exact = held.exact_report()
    del held
    free_cuda(torch)
    control = ssd_row_control(torch, cfg, model, prompt, want["ssd_chunk"]) \
        if "ssd_chunk" in want else None
    free_cuda(torch)
    fed = res.tokens[:, :SERVE_STEPS]
    plain_rel, plain_mean = rel_err(torch, got, plain_served_logits(
        torch, cfg, model, {"tokens": prompt}, fed))
    free_cuda(torch)
    t0 = time.perf_counter()
    want_logits = tail_reference_logits(torch, cfg, model, prompt, fed)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    max_rel, mean_rel = rel_err(torch, got, want_logits)
    agree = float((got.argmax(-1) == want_logits.argmax(-1)).float().mean())
    emit({"phase": f"serve_{cfg.family}", "arch": arch,
          "layers": cfg.n_layers, "dtype": cfg.dtype,
          "params": models.count_params(cfg), "batch": SERVE_BATCH,
          "prompt_len": prompt_len, "decode_steps": SERVE_STEPS,
          "init_s": init_s, "prefill_s": res.prefill_s,
          "decode_ms_per_token": res.decode_s / SERVE_STEPS * 1e3,
          "peak_mem_gb": peak_gb, "launches": launches,
          "vs_plain_serve_max_rel_err": plain_rel,
          "vs_plain_serve_mean_rel_err": plain_mean,
          "vs_plain_serve_tolerance": SERVE_BF16_TOL,
          "logits_max_rel_err": max_rel, "logits_mean_rel_err": mean_rel,
          "tolerance": FORWARD_BF16_TOL[arch], "argmax_agreement": agree,
          "layer_max_row_rel_err": layer_errs,
          "layer_row_tolerance": {**KERNEL_ROW_TOL,
                                  "ssd_chunk": SSD_ROW_TOL},
          "layer_max_row_rel_err_vs_f64": layer_exact,
          "ssd_row_control": control,
          "reference_s": ref_s, "profile": profiled})
    check(plain_rel <= SERVE_BF16_TOL, f"{arch} logits differ from the "
          f"plain path's serving run by {plain_rel} of max|logit| "
          f"(tolerance {SERVE_BF16_TOL})")
    check(max_rel <= FORWARD_BF16_TOL[arch], f"{arch} logits differ from "
          f"the plain full forward by {max_rel} of max|logit| (tolerance "
          f"{FORWARD_BF16_TOL[arch]})")
    del model, got, want_logits
    free_cuda(torch)
    return {k: launches[k] for k in want}


def phase_serve_family_f32(torch, arch):
    """The tight check: ``arch`` at full width with FAMILY_F32_LAYERS
    layers in float32, matmuls in full float32 (TF32 off): the served
    logits against the plain full forward (SERVE_F32_TOL), and each
    layer's kernel output against its plain version on the same inputs
    (:func:`layer_row_tol`, float32)."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    n_layers = FAMILY_F32_LAYERS[arch]
    cfg = get_config(arch).replace(n_layers=n_layers, dtype="float32")
    per_layer = family_launches(cfg)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = models.init(cfg, 0, device="cuda")
        prompt = make_batch(cfg, SERVE_BATCH, FAMILY_PROMPT[arch], 0, 0,
                            device="cuda")["tokens"]
        zero_launches()
        with HeldAgainstPlain(torch) as held:
            res = serve.serve(cfg, model, {"tokens": prompt}, SERVE_STEPS)
        check_launches(dict(ops.LAUNCHES), per_layer, f"{arch} f32")
        layer_errs = held.report(per_layer)
        got = served_logits(torch, res)
        res.cache.clear()
        want = tail_reference_logits(torch, cfg, model, prompt,
                                     res.tokens[:, :SERVE_STEPS])
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    max_rel, mean_rel = rel_err(torch, got, want)
    emit({"phase": f"serve_{cfg.family}_f32", "arch": arch,
          "layers": n_layers, "dtype": "float32", "allow_tf32": False,
          "logits_max_rel_err": max_rel, "logits_mean_rel_err": mean_rel,
          "tolerance": SERVE_F32_TOL, "layer_max_row_rel_err": layer_errs,
          "layer_row_tolerance": {"float32": KERNEL_ROW_TOL["float32"],
                                  "ssd_chunk": SSD_ROW_TOL}})
    check(max_rel <= SERVE_F32_TOL, f"f32 {arch} serving differs from the "
          f"plain path by {max_rel} (tolerance {SERVE_F32_TOL})")
    del model, got, want
    free_cuda(torch)


def phase_serve_family_card_vs_cpu(torch, arch, prompt_len=80):
    """The smoke config's kernel path on the card against the CPU plain
    path, same weights, same tokens (the card's greedy tokens are fed to
    the CPU run). 80 prompt tokens: not a multiple of mamba2-smoke's
    32-token chunk, and longer than recurrentgemma-smoke's 64-token
    window."""
    from repro_torch import models
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = get_smoke_config(arch).replace(dtype="float32")
    cpu_model = models.init(cfg, 0, device="cpu")
    card_model = models.init(cfg, 0, device="cpu").to("cuda")
    prompt = make_batch(cfg, 2, prompt_len, 0, 0, device="cpu")["tokens"]
    zero_launches()
    res = serve.serve(cfg, card_model, {"tokens": prompt.cuda()}, 8)
    check_launches(dict(ops.LAUNCHES), family_launches(cfg),
                   f"the card's {cfg.name} run")
    logits, cache = models.prefill(cfg, cpu_model, {"tokens": prompt})
    want = [logits]
    for i in range(8):
        step, cache = models.serve_step(cfg, cpu_model, cache,
                                        res.tokens[:, i:i + 1].cpu())
        want.append(step)
    max_rel, _ = rel_err(torch, served_logits(torch, res).cpu(),
                         torch.cat(want, dim=1))
    emit({"phase": f"serve_{cfg.family}_card_vs_cpu", "arch": cfg.name,
          "batch": 2, "prompt_len": prompt_len, "decode_steps": 8,
          "launches": dict(ops.LAUNCHES), "logits_max_rel_err": max_rel,
          "tolerance": CARD_VS_CPU_TOL})
    check(max_rel <= CARD_VS_CPU_TOL, f"card kernel path differs from the "
          f"CPU plain path by {max_rel} (tolerance {CARD_VS_CPU_TOL})")


# The moe, vlm and audio families' serving (phases serve_moe, serve_vlm,
# serve_audio), bf16, random weights from seed 0, make_batch's batch from
# seed 0: arch -> (layers, None for the full depth; batch; make_batch's
# seq_len; decode steps). qwen3-moe at full depth, 4 x 2048 prompt
# tokens; mixtral-8x22b at full width and 2 layers (141e9 parameters do
# not fit one card; 2 layers are 10.8 GB), 1 x 8192 tokens so that its
# 4096-token window binds in the kernel and tokens drop at its capacity
# of 2560 a group; internvl2 4 x (256 visual + 1792 text); whisper 4 x
# (1500 frames + 224 decoder tokens), 256 positions with the decode
# steps, inside the decoder's 448-token cap.
NEW_FAMILY_SERVE = {
    "qwen3-moe-30b-a3b": (None, SERVE_BATCH, 2048, SERVE_STEPS),
    "mixtral-8x22b": (2, 1, 8192, 16),
    "internvl2-2b": (None, SERVE_BATCH, 2048, SERVE_STEPS),
    "whisper-large-v3": (None, SERVE_BATCH, 1724, SERVE_STEPS),
}
NEW_FAMILY_PHASES = {"serve_moe": ("qwen3-moe-30b-a3b", "mixtral-8x22b"),
                     "serve_vlm": ("internvl2-2b",),
                     "serve_audio": ("whisper-large-v3",)}


class Routes:
    """While active, every ``moe.top_k`` call's expert indices are kept
    in call order (a prefill's layers, then each decode step's); with
    ``replay`` (another run's list) each call returns the replayed
    indices, with this run's own probabilities at them, in place of its
    own picks: the same routes on another path."""

    def __init__(self, replay=None):
        self.replay = replay
        self.idx = []

    def __enter__(self):
        from repro_torch.models import moe
        self.orig = moe.top_k

        def top_k(probs, k):
            if self.replay is None:
                vals, idx = self.orig(probs, k)
            else:
                idx = self.replay[len(self.idx)]
                vals = probs.gather(-1, idx)
            self.idx.append(idx.clone())
            return vals, idx

        moe.top_k = top_k
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.top_k = self.orig


def pick_flips(a, b):
    """The share of (token, k) picks of ``a`` (..., k) that are not among
    ``b``'s picks for the same token."""
    k = a.shape[-1]
    same = (a[..., :, None] == b[..., None, :]).any(-1).sum(-1)
    return float((k - same).sum()) / a.numel()


def dropped_share(torch, idx, n_experts, cap):
    """The share of a prefill layer's assignments (idx (B, S, k)) ranked
    at or past ``cap`` in their expert, each batch row a group."""
    counts = torch.stack([torch.bincount(row.reshape(-1),
                                         minlength=n_experts)
                          for row in idx])
    return float((counts - cap).clamp_min(0).sum()) / idx.numel()


def max_abs(t):
    return float(t.float().abs().max())


def phase_serve_new_family(torch, arch):
    """A serving main path of the moe, vlm or audio family:
    NEW_FAMILY_SERVE's config and batch through ``launch.serve`` (one
    flash launch a layer per prefill: the dense stack's, or whisper's
    decoder self-attention alone; none in decode), its logits held
    against a plain serving run on the served tokens (SERVE_BF16_TOL);
    the prefill profiled; one more prefill with each layer's kernel
    output held against the plain attention per row
    (FLASH_BF16_ROW_TOL). For a moe an untimed repeat of the served run
    records each layer's routes (one copy of the (B, S, k) indices a
    layer and step); the plain run that decides replays them (no route
    flipped), and the flips against the plain path's own routes and the
    dropped share are reported. Whisper's encoder alone must launch
    nothing. The whole (B, S, V) logits are never formed: every
    reference serves. ``seconds`` splits the phase's
    wall time."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import moe
    layers, batch_n, seq_len, steps = NEW_FAMILY_SERVE[arch]
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    want = {"flash_attention": cfg.n_layers}
    is_moe = cfg.family == "moe"
    seconds, t_last = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        seconds[name] = now - t_last[0]
        t_last[0] = now

    model = models.init(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    lap("init")
    init_s = seconds["init"]
    batch = make_batch(cfg, batch_n, seq_len, 0, 0, device="cuda")
    serve.serve(cfg, model, dict(batch, tokens=batch["tokens"][:, :64]),
                2)                                       # warm-up
    free_cuda(torch)
    lap("batch_and_warm_up")
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    res = serve.serve(cfg, model, batch, steps)
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_launches(launches, want, f"serving {arch}")
    check(tuple(res.tokens.shape) == (batch_n, steps + 1), "bad token shape")
    served = served_logits(torch, res)
    check(bool(torch.isfinite(served).all()), f"non-finite {arch} logits")
    res.cache.clear()
    free_cuda(torch)
    lap("served")
    if is_moe:
        # the routes, from a repeat that the times do not include; greedy
        # decoding makes it choose the served run's tokens
        with Routes() as routes:
            repeat = serve.serve(cfg, model, batch, steps)
        repeat.cache.clear()
        check(torch.equal(repeat.tokens, res.tokens), f"{arch}: a repeat "
              "of the served run chose other tokens")
        free_cuda(torch)
        lap("routes_repeat")
    encoder = None
    if cfg.family == "audio":
        from repro_torch.models import whisper
        zero_launches()
        with torch.no_grad():
            whisper.encode(cfg, model, batch["audio_embeds"])
        torch.cuda.synchronize()
        encoder = dict(ops.LAUNCHES)
        check_launches(encoder, {}, f"{arch}'s encoder")
        free_cuda(torch)
    state = {}

    def prefill():
        state["logits"], state["cache"] = models.prefill(
            cfg, model, batch,
            pad_to=serve.prompt_positions(cfg, batch) + 1)

    def decode():
        tok = state["logits"][:, -1].argmax(-1)[:, None].to(torch.int32)
        models.serve_step(cfg, model, state["cache"], tok)

    # one decode step: the profiler's own processing of qwen3-moe's
    # ~6,500 kernels a step takes seconds
    profiled = {"prefill": device_breakdown(torch, prefill)}
    zero_launches()
    profiled["decode_1_step"] = device_breakdown(torch, decode)
    check_launches(dict(ops.LAUNCHES), {}, f"{arch} decode")
    state.clear()
    free_cuda(torch)
    lap("encoder_and_profile")
    fed = res.tokens[:, :steps]
    with HeldAgainstPlain(torch) as held:
        models.prefill(cfg, model, batch)
    layer_errs = held.report(want)
    del held
    free_cuda(torch)
    lap("held_prefill")
    out = {"phase": f"serve_{cfg.family}",
           "arch": arch, "layers": cfg.n_layers,
           "depth_cut": layers is not None, "dtype": cfg.dtype,
           "params": models.count_params(cfg), "batch": batch_n,
           "seq_len": seq_len, "prompt_positions":
               serve.prompt_positions(cfg, batch),
           "decode_steps": steps, "init_s": init_s,
           "prefill_s": res.prefill_s,
           "decode_ms_per_token": res.decode_s / steps * 1e3,
           "peak_mem_gb": peak_gb, "launches": launches,
           "encoder_launches": encoder,
           "layer_max_row_rel_err": layer_errs,
           "layer_row_tolerance": FLASH_BF16_ROW_TOL}
    refs = {}
    with Routes() as own:
        refs["plain"] = plain_served_logits(torch, cfg, model, batch, fed)
    free_cuda(torch)
    lap("plain_run")
    if is_moe:
        out["routes_repeat_prefill_s"] = repeat.prefill_s
        out["routes_repeat_decode_ms_per_token"] = \
            repeat.decode_s / steps * 1e3
        with Routes(replay=routes.idx) as rep:
            refs["plain_replayed_routes"] = plain_served_logits(
                torch, cfg, model, batch, fed)
        check(len(rep.idx) == len(routes.idx) == len(own.idx)
              == cfg.n_layers * (steps + 1), "routes not recorded once "
              "per layer and step")
        free_cuda(torch)
        lap("plain_replayed_run")
        L, cap = cfg.n_layers, moe.capacity(cfg, batch["tokens"].shape[1])
        pre = list(zip(routes.idx[:L], own.idx[:L]))
        out["route_flips"] = [pick_flips(a, b) for a, b in pre]
        out["route_flips_decode"] = [
            pick_flips(torch.stack(routes.idx[L + li::L]),
                       torch.stack(own.idx[L + li::L])) for li in range(L)]
        out["dropped_share"] = [dropped_share(torch, a, cfg.moe.num_experts,
                                              cap) for a, _ in pre]
        out["capacity"] = cap
        del routes, repeat
    del own
    # Serving agreement, max|served - plain| over max|plain|, held to
    # SERVE_BF16_TOL (the flash kernel rounds p at other points than the
    # plain attention, as in phase serve) against one plain serving run:
    # - vlm, audio: the plain path's own;
    # - moe: the plain path with the served run's routes replayed, so
    #   that no layer can flip a route. On its own routes a router near
    #   a tie may pick another expert (route_flips): another function
    #   of the token, no rounding step, so no bound follows from the
    #   rounding points. That comparison ("plain") and the flips' own
    #   effect (flips_alone_max_rel) are readings; neither decides.
    decides = "plain_replayed_routes" if is_moe else "plain"
    errs = {name: rel_err(torch, served, ref)[0]
            for name, ref in refs.items()}
    if is_moe:
        rep, own_l = refs["plain_replayed_routes"], refs["plain"]
        out["flips_alone_max_rel"] = max_abs(rep - own_l) / max_abs(own_l)
    agree = float((served.argmax(-1) == refs["plain"].argmax(-1))
                  .float().mean())
    lap("compare")
    out.update({"vs_plain_max_rel_err": errs, "decided_by": decides,
                "tolerance": SERVE_BF16_TOL, "argmax_agreement": agree,
                "profile": profiled, "seconds": seconds})
    emit(out)
    check(max(layer_errs.values()) <= FLASH_BF16_ROW_TOL,
          f"{arch}: a layer's flash output differs from the plain attention")
    check(errs[decides] <= SERVE_BF16_TOL, f"{arch} logits differ from "
          f"the {decides} serving run by {errs[decides]} of max|logit| "
          f"(tolerance {SERVE_BF16_TOL})")
    del model, served, refs
    free_cuda(torch)
    return launches["flash_attention"]


# Training: stablelm-12b at its published widths, depth cut to 2 layers
# (bf16 parameters, f32 AdamW moments, remat "full"), 4 x 2048 tokens a
# step from make_batch, 4 steps of launch.train.train (its schedule:
# warmup 1, cosine to 0 at step 4); the state saved after step 2 and
# restored, steps 3-4 replayed bit for bit.
TRAIN_ARCH = SERVE_ARCH
TRAIN_LAYERS = 2
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
# lr 3e-5: AdamW's first step moves every weight by about the learning
# rate in its gradient's sign, and at full width with the JAX init (wq's
# scale 1.7e-3: its fan-in counts the layer axis) a larger rate swamps
# the weights; on the H100 the loss rose at lr 1e-3 (12.03 -> 24.48 ->
# 12.10 -> 13.68, eval 12.02 -> 13.78) and at 1e-4 (12.03 -> 18.85 ->
# 13.20 -> 11.90, eval 12.02 -> 12.11)
TRAIN_STEPS, TRAIN_SAVE_AFTER, TRAIN_LR = 4, 2, 3e-5
# the smoke config's train steps, card against CPU (f32, TF32 off): the
# losses within 1e-4 relative (the order of sums differs)
TRAIN_CARD_VS_CPU_TOL = 1e-4
# the H100's dense bf16 peak (NVIDIA's data sheet, SXM, 700 W) and the
# storage rate estimate_grace_period assumes
PEAK_BF16_FLOPS = h100.PEAK_BF16_FLOPS
ASSUMED_STORAGE_BPS = 2e9

def kernel_refuses_grad(torch):
    """Whether ``ops.flash_attention`` raises on a CUDA query that
    requires grad (the kernel has no backward), launching nothing."""
    from repro_torch.kernels import ops
    q = torch.randn(1, 128, 4, 32, device="cuda", requires_grad=True)
    k = torch.randn(1, 128, 2, 32, device="cuda")
    before = ops.LAUNCHES["flash_attention"]
    try:
        ops.flash_attention(q, k, k)
    except RuntimeError as e:
        return "no backward" in str(e) and \
            ops.LAUNCHES["flash_attention"] == before
    return False


def phase_train(torch):
    """The training main path: stablelm-12b at full width, 2 layers,
    through ``launch.train.train`` (attention's plain path, no kernel),
    with a checkpoint after step 2 restored and steps 3-4 replayed. The
    dry-run (``launch.dryrun.dry_run`` on the meta device, the local
    mesh) of the same step is held against the card: its train-state
    argument bytes must equal the real state's bytes; its ``temp_gb``,
    ``peak_gb`` and roofline ``compute_s`` are printed beside the
    measured peak and s/step as readings."""
    import shutil
    from repro_torch import models, trainer
    from repro_torch.checkpoint import (estimate_grace_period, load_pytree,
                                        save_pytree, state_bytes)
    from repro_torch.configs import InputShape, get_config
    from repro_torch.data import make_eval_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_local_mesh
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS)
    check(cfg.dtype == "bfloat16" and cfg.remat == "full",
          f"unexpected training config {cfg.dtype}, remat {cfg.remat}")
    refuses = kernel_refuses_grad(torch)
    check(refuses, "ops.flash_attention took a CUDA input that requires "
          "grad")
    ocfg = launch_train.opt_config(TRAIN_STEPS, TRAIN_LR)
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    ckpt = os.path.join(tmp, "step2.npz")
    io = {}

    def save_after(i, state, metrics):
        if i == TRAIN_SAVE_AFTER - 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            io["bytes"] = save_pytree(state, ckpt)
            io["write_s"] = time.perf_counter() - t0

    kw = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
              lr=TRAIN_LR, seed=0, device="cuda", log=None)
    try:
        t0 = time.perf_counter()
        state = trainer.init_train_state(cfg, ocfg, 0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        sbytes = state_bytes(state)
        grace = estimate_grace_period(
            state, storage_bw_bytes_per_s=ASSUMED_STORAGE_BPS)
        ev = make_eval_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
        with torch.no_grad():
            eval_before = float(models.loss_fn(cfg, state["params"], ev))
        res = launch_train.train(cfg, state=state, on_step=save_after, **kw)
        with torch.no_grad():
            eval_after = float(models.loss_fn(cfg, res.state["params"], ev))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        final = {n: p.detach().clone()
                 for n, p in res.state["params"].named_parameters()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = load_pytree(res.state, ckpt)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        restored_step = int(state["opt"]["step"])
        replay = launch_train.train(cfg, state=state,
                                    start=TRAIN_SAVE_AFTER, **kw)
        params_equal = all(
            torch.equal(p, final[n])
            for n, p in replay.state["params"].named_parameters())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(ops.LAUNCHES)
    losses, step_s, replayed = res.losses, res.step_s, replay.losses
    resume_equal = replayed == losses[TRAIN_SAVE_AFTER:] and params_equal
    del state, res, replay, final
    free_cuda(torch)
    # after the steps: their remat has imported torch._dynamo, which the
    # dry-run's dispatch mode would otherwise import on its first use
    t0 = time.perf_counter()
    dry = dryrun.dry_run(cfg, InputShape("train_smoke", TRAIN_SEQ,
                                         TRAIN_BATCH, "train"),
                         make_local_mesh())
    dry_s = time.perf_counter() - t0
    n_params = models.count_params(cfg)
    counted = active_matmul_params(cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # the first step pays for the allocator's and cuBLAS's warm-up
    s_per_step = statistics.mean(step_s[1:])
    emit({"phase": "train", "arch": TRAIN_ARCH, "layers": cfg.n_layers,
          "dtype": cfg.dtype, "moments": ocfg.moment_dtype,
          "remat": cfg.remat, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
          "steps": TRAIN_STEPS, "lr": TRAIN_LR,
          "warmup_steps": ocfg.warmup_steps, "params": n_params,
          "active_params": counted, "init_s": init_s, "losses": losses, "replayed_losses": replayed,
          "step_s": step_s, "s_per_step": s_per_step,
          "tokens_per_s": tokens / s_per_step,
          "step_tflops": 6 * counted * tokens / s_per_step / 1e12,
          "peak_tflops": PEAK_BF16_FLOPS / 1e12,
          "eval_loss_before": eval_before, "eval_loss_after": eval_after,
          "peak_device_gb": peak_gb, "state_gb": sbytes / 1e9,
          "ckpt_gb": io["bytes"] / 1e9, "ckpt_write_s": io["write_s"],
          "ckpt_write_gbps": io["bytes"] / io["write_s"] / 1e9,
          "ckpt_read_s": read_s,
          "ckpt_read_gbps": io["bytes"] / read_s / 1e9,
          "assumed_gbps": ASSUMED_STORAGE_BPS / 1e9,
          "grace_period_min": grace, "restored_step": restored_step,
          "resume_bit_equal": resume_equal, "launches": launches,
          "kernel_refuses_grad": refuses,
          "dryrun": {"seconds": dry_s, "mesh": dry["mesh"],
                     "strategy": dry["strategy"],
                     "state_bytes": dry["memory"]["argument_bytes"]["state"],
                     "temp_gb": dry["memory"]["temp_gb"],
                     "peak_gb": dry["memory"]["peak_gb"],
                     "temp_gb_upper_bound":
                         dry["memory"]["temp_gb_upper_bound"],
                     "compute_s": dry["roofline"]["compute_s"],
                     "counted_flops": dry["counted_flops_per_device"]}})
    check(dry["memory"]["argument_bytes"]["state"] == sbytes,
          f"the dry-run's train-state bytes "
          f"{dry['memory']['argument_bytes']['state']} differ from the "
          f"state's {sbytes}")
    check(all(math.isfinite(x) for x in losses),
          f"non-finite training loss in {losses}")
    check(eval_after < eval_before, f"the eval loss did not drop: "
          f"{eval_before} -> {eval_after}")
    check(restored_step == TRAIN_SAVE_AFTER,
          f"the checkpoint restored step {restored_step}")
    check(resume_equal, "steps 3-4 replayed from the checkpoint differ "
          "from the uninterrupted run")
    check(not any(launches.values()),
          f"the train path launched kernels: {launches}")


def phase_train_card_vs_cpu(torch):
    """The smoke config's train steps on the card against the same steps
    on the CPU: float32 (TF32 off), the same initial parameters and
    tokens; each step's loss within TRAIN_CARD_VS_CPU_TOL relative."""
    from repro_torch import trainer
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_batch
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get_smoke_config(TRAIN_ARCH).replace(dtype="float32")
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    losses = {}
    try:
        for dev in ("cuda", "cpu"):
            model = trainer.init_train_state(cfg, ocfg, 0,
                                             device="cpu")["params"].to(dev)
            state = {"params": model, "opt": adamw_init(model, ocfg)}
            step, losses[dev] = trainer.make_train_step(cfg, ocfg), []
            for i in range(2):
                toks = make_batch(cfg, 4, 64, 0, i, device="cpu")["tokens"]
                state, m = step(state, {"tokens": toks.to(dev)})
                losses[dev].append(float(m["loss"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    max_rel = max(abs(a - b) / abs(b)
                  for a, b in zip(losses["cuda"], losses["cpu"]))
    emit({"phase": "train_card_vs_cpu", "arch": cfg.name,
          "dtype": "float32", "allow_tf32": False, "losses": losses,
          "loss_max_rel_err": max_rel, "tolerance": TRAIN_CARD_VS_CPU_TOL})
    check(max_rel <= TRAIN_CARD_VS_CPU_TOL, f"the card's train step differs "
          f"from the CPU's by {max_rel} (tolerance {TRAIN_CARD_VS_CPU_TOL})")


# training of the families past the dense one at their published widths
# (phases train_ssm, train_hybrid, train_moe, train_vlm, train_audio):
# (phase, arch, layers (None: all), batch, seq_len, AdamW moment type,
# lr), bf16, remat "full", TRAIN_FAMILY_STEPS steps through
# launch.train.train, no checkpoint (phase train covers its host I/O);
# seq_len counts the vlm's 256 visual and whisper's 1,500 frame
# positions, as make_batch does (1,792 text and 224 decoder tokens).
# mamba2-1.3b at full depth (48 layers, 1,343,532,032 parameters);
# recurrentgemma-9b at 3 layers, one (rec, rec, attn) group
# (1,642,156,032 parameters), 1 x 4096 tokens so the 2048-token local
# window is exercised: at 2 x 4096 the 256,000-token vocabulary's f32
# logits, their softcap and their gradient (8.4 GB each) ran the card
# out of memory (63 GB allocated and 10 GB reserved when an 8.4 GB block
# was asked for, H100 80 GB). qwen3-moe-30b-a3b (30.5e9 parameters) at 2
# of its 48 layers (1.87e9 parameters with the embedding and output
# head): about 22 B a parameter with f32 moments while AdamW holds the
# old and new state side by side, plus the 151,936-token vocabulary's
# f32 logits and their gradient; at 3 layers (2.49e9) the first backward
# ran the H100 out of memory: 56.0 GB allocated and 17.8 GB reserved but
# unallocated when it asked for 4.63 GiB, an f32 logits-sized buffer
# (20.9 GB before the init handed its temporaries back).
# mixtral-8x22b at 1 of its 56 layers (2.9e9 parameters, one expert leaf
# 8 x 6144 x 16384), bf16 moments, 1 x 8192 tokens so its 4,096 window
# binds, at lr 1e-5: AdamW's first step moves every weight by the
# learning rate in its gradient's sign, which can move a product's
# output by lr x its fan-in F, against the output's own size sqrt(F) x
# the init scale, whose fan-in counts the stacked axes too; for w_down
# (layers, experts, F, D) the ratio is lr x F x sqrt(layers x experts):
# 0.59 for stablelm's 2 layers at phase train's 3e-5 (its loss rose
# once, then fell), 0.37 for qwen3-moe at 2 layers, 1.39 for mixtral at
# 3e-5, whose eval loss rose on the H100 (10.919 -> 11.956; losses
# 10.93, 15.71, 11.90), and 0.46 at 1e-5. internvl2-2b and
# whisper-large-v3 at full depth (24; 32 + 32 layers).
TRAIN_FAMILIES = (
    ("train_ssm", SSM_ARCH, None, 4, 2048, "float32", TRAIN_LR),
    ("train_hybrid", HYBRID_ARCH, 3, 1, 4096, "float32", TRAIN_LR),
    ("train_moe", "qwen3-moe-30b-a3b", 2, 4, 2048, "float32", TRAIN_LR),
    ("train_moe", "mixtral-8x22b", 1, 1, 8192, "bfloat16", 1e-5),
    ("train_vlm", "internvl2-2b", None, 4, 2048, "float32", TRAIN_LR),
    ("train_audio", "whisper-large-v3", None, 4, 1724, "float32", TRAIN_LR),
)
TRAIN_FAMILY_STEPS = 3


def train_launches(cfg, evals):
    """{kernel: launches} of TRAIN_FAMILY_STEPS train steps and
    ``evals`` no-grad evaluations of ``cfg`` on the training route.
    Only the hybrid launches any (the ssm's intra-chunk term takes the
    plain version; attention, where any, its plain path). A hybrid step
    runs each recurrent layer's ``LruScan`` forward once, again when its
    (rec, rec, attn) group is recomputed under remat "full" (not for
    the remainder layers, which JAX does not remat either), and its
    reverse launch once; an evaluation launches the forward once."""
    if cfg.family != "hybrid":
        return {}
    from repro_torch.models import hybrid
    g, _, n_rec, _ = hybrid.layer_layout(cfg)
    grouped = g * cfg.recurrent.block_pattern.count("rec")
    per_step = 3 * grouped + 2 * (n_rec - grouped)
    return {"lru_scan": per_step * TRAIN_FAMILY_STEPS + n_rec * evals}


def active_matmul_params(cfg):
    """The parameters a token's matrix products use, by the roofline's
    rule (``repro_torch.launch.roofline._matmul_params``, the JAX
    package's): all but the embedding (a gather), less the experts a
    token is not routed to, plus the embedding again where it is tied
    (the unembedding's product). Counted TFLOP/s are 6 x this x tokens a
    step."""
    from repro_torch.launch import roofline
    return int(roofline._matmul_params(cfg)[0])


def moe_train_routes(torch, cfg, routes, seq):
    """From ``routes`` (a ``Routes`` over the train steps): each layer's
    ``dropped_share`` in the first step's forward, and whether every
    step's remat recompute (a step's second n_layers ``top_k`` calls, the
    last layer's first) picked the forward's experts for every token."""
    from repro_torch.models import moe
    L = cfg.n_layers
    check(len(routes.idx) == 2 * L * TRAIN_FAMILY_STEPS,
          f"{cfg.name}: {len(routes.idx)} top_k calls in "
          f"{TRAIN_FAMILY_STEPS} steps of {L} layers under remat")
    cap = moe.capacity(cfg, seq)
    dropped = [dropped_share(torch, routes.idx[li], cfg.moe.num_experts, cap)
               for li in range(L)]
    same = all(torch.equal(routes.idx[s * 2 * L + li],
                           routes.idx[s * 2 * L + 2 * L - 1 - li])
               for s in range(TRAIN_FAMILY_STEPS) for li in range(L))
    return dropped, same


def phase_train_family(torch, path, arch, layers, batch, seq, moments, lr):
    """Training for a family past the dense one at its published widths
    through ``launch.train.train`` (an AdamW config with ``moments``,
    the launcher's schedule at ``lr``): finite losses, a lower eval loss
    after TRAIN_FAMILY_STEPS steps, exactly :func:`train_launches` model
    kernel launches (none but the hybrid's ``lru_scan``), peak device
    memory under the card's 80 GB; s/step, tokens/s and TFLOP/s counted
    by :func:`active_matmul_params`. The moe also reports each layer's
    ``dropped_share`` in the first step and fails unless each step's
    remat recompute picked the forward's routes. Returns the phase's
    launches."""
    from repro_torch import models, trainer
    from repro_torch.configs import get_config
    from repro_torch.data import make_eval_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    check(cfg.dtype == "bfloat16" and cfg.remat == "full",
          f"unexpected training config {cfg.dtype}, remat {cfg.remat}")
    ocfg = dataclasses.replace(launch_train.opt_config(TRAIN_FAMILY_STEPS,
                                                       lr),
                               moment_dtype=moments)
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    state = trainer.init_train_state(cfg, ocfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ev = make_eval_batch(cfg, batch, seq, device="cuda")
    with torch.no_grad():
        eval_before = float(models.loss_fn(cfg, state["params"], ev))
    eval_launches = dict(ops.LAUNCHES)
    zero_launches()
    routes = Routes()
    with routes if cfg.family == "moe" else contextlib.nullcontext():
        res = launch_train.train(cfg, state=state, steps=TRAIN_FAMILY_STEPS,
                                 batch=batch, seq_len=seq, lr=lr, seed=0,
                                 device="cuda", log=None, opt_cfg=ocfg)
    step_launches = dict(ops.LAUNCHES)
    zero_launches()
    with torch.no_grad():
        eval_after = float(models.loss_fn(cfg, res.state["params"], ev))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: eval_launches[k] + step_launches[k] + ops.LAUNCHES[k]
                for k in ops.LAUNCHES}
    losses, step_s = res.losses, res.step_s
    out = {}
    if cfg.family == "moe":
        out["dropped_share"], out["remat_routes_equal"] = moe_train_routes(
            torch, cfg, routes, seq)
    del state, res, ev, routes
    free_cuda(torch)
    n_params = models.count_params(cfg)
    counted = active_matmul_params(cfg)
    tokens = batch * seq
    # the first step pays for the allocator's and cuBLAS's warm-up
    s_per_step = statistics.mean(step_s[1:])
    want = train_launches(cfg, evals=2)
    emit({"phase": path, "arch": arch, "layers": cfg.n_layers,
          "layers_published": get_config(arch).n_layers,
          "dtype": cfg.dtype, "moments": moments, "remat": cfg.remat,
          "batch": batch, "seq_len": seq, "steps": TRAIN_FAMILY_STEPS,
          "lr": lr, "params": n_params, "active_params": counted,
          "init_s": init_s, "losses": losses, "step_s": step_s,
          "s_per_step": s_per_step, "tokens_per_s": tokens / s_per_step,
          "step_tflops": 6 * counted * tokens / s_per_step / 1e12,
          "peak_tflops": PEAK_BF16_FLOPS / 1e12,
          "eval_loss_before": eval_before, "eval_loss_after": eval_after,
          "peak_device_gb": peak_gb, "launches": launches,
          "launches_train_steps": step_launches,
          "launches_expected": want, **out})
    where = f"{path} {arch}"
    check(all(math.isfinite(x) for x in losses),
          f"{where}: non-finite training loss in {losses}")
    check(eval_after < eval_before, f"{where}: the eval loss did not drop: "
          f"{eval_before} -> {eval_after}")
    check(peak_gb < 80.0, f"{where}: peak device memory {peak_gb} GB")
    check_launches(launches, want, where)
    if cfg.family == "moe":
        check(out["remat_routes_equal"], f"{where}: a remat recompute "
              "picked other experts than its forward")
    return launches


def phase_train_family_card_vs_cpu(torch, arch):
    """The ssm or hybrid smoke config's train steps on the card against
    the same steps on the CPU: float32 (TF32 off), each side's initial
    parameters and tokens drawn on its own device (equal by
    construction: counter-based init, tokens drawn on the CPU); each
    step's loss within TRAIN_CARD_VS_CPU_TOL relative."""
    from repro_torch import trainer
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamWConfig
    cfg = get_smoke_config(arch).replace(dtype="float32")
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    losses, init_equal = {}, True
    zero_launches()
    try:
        states = {dev: trainer.init_train_state(cfg, ocfg, 0, device=dev)
                  for dev in ("cuda", "cpu")}
        for (n, a), (_, b) in zip(
                states["cuda"]["params"].named_parameters(),
                states["cpu"]["params"].named_parameters()):
            init_equal = init_equal and bool(torch.equal(a.cpu(), b))
        for dev in ("cuda", "cpu"):
            state = states[dev]
            step, losses[dev] = trainer.make_train_step(cfg, ocfg), []
            for i in range(2):
                state, m = step(state, make_batch(cfg, 4, 64, 0, i,
                                                  device=dev))
                losses[dev].append(float(m["loss"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    launches = dict(ops.LAUNCHES)
    max_rel = max(abs(a - b) / abs(b)
                  for a, b in zip(losses["cuda"], losses["cpu"]))
    emit({"phase": f"train_{cfg.family}_card_vs_cpu", "arch": cfg.name,
          "dtype": "float32", "allow_tf32": False, "losses": losses,
          "init_bit_equal": init_equal, "launches": launches,
          "loss_max_rel_err": max_rel, "tolerance": TRAIN_CARD_VS_CPU_TOL})
    check(init_equal, f"{cfg.name}: the card's initial parameters differ "
          "from the CPU's")
    check(max_rel <= TRAIN_CARD_VS_CPU_TOL, f"{cfg.name}: the card's train "
          f"step differs from the CPU's by {max_rel} (tolerance "
          f"{TRAIN_CARD_VS_CPU_TOL})")


# the live controller: the JAX package's preempt/resume case on its own
# config, internvl2-2b's smoke (bf16; its batches carry patch
# embeddings), and on the dense smoke config; its two cases that train
# the mamba2 smoke config (TE latency under fitgpp and fifo; the
# short-grace-period victim)
CONTROLLER_ARCH = TRAIN_ARCH
CONTROLLER_SSM_ARCH = SSM_ARCH
CONTROLLER_VLM_ARCH = "internvl2-2b"
CONTROLLER_NODE = (32.0, 256.0, 8.0)


def controller_case(np, ctl_mod, cfg, case, policy, device, workdir):
    """One controller run: ``be_te`` or ``be_te_vlm`` (one node; BE be0
    for 16 steps, demand (8, 32, 8); TE te0 for 2 steps, demand (4, 16,
    8), at tick 2; grace periods estimated from the live state; the
    JAX suite's preempt/resume case), ``te_latency`` (one
    node; be0 for 30 steps, te0 (4, 16, 4) for 2 at tick 1), ``victim``
    (2 nodes, s = 4; BE jobs of 40 steps with grace periods of 5 and 1
    ticks, a TE at tick 1; one step a tick) or ``fleet`` (like
    ``examples/preemptible_training.py``: 2 nodes, s = 4, BE jobs with
    grace periods of 5 and 1 ticks, a TE at tick 1 and another, with an
    estimated grace period, at tick 6). Returns the controller."""
    np = __import__("numpy")
    spec = ctl_mod.JobSpec
    if case in ("be_te", "be_te_vlm"):
        ctl = ctl_mod.Controller(n_nodes=1, node_cap=CONTROLLER_NODE,
                                 policy=policy, steps_per_tick=2,
                                 workdir=workdir, device=device)
        ctl.submit(spec("be0", cfg, False, np.array([8., 32., 8.]),
                        total_steps=16))
        ctl.submit(spec("te0", cfg, True, np.array([4., 16., 8.]),
                        total_steps=2, submit_tick=2))
    elif case == "te_latency":      # the JAX suite's, on mamba2's smoke
        ctl = ctl_mod.Controller(n_nodes=1, node_cap=CONTROLLER_NODE,
                                 policy=policy, steps_per_tick=2,
                                 workdir=workdir, device=device)
        ctl.submit(spec("be0", cfg, False, np.array([8., 32., 8.]),
                        total_steps=30))
        ctl.submit(spec("te0", cfg, True, np.array([4., 16., 4.]),
                        total_steps=2, submit_tick=1))
    elif case == "victim":          # the JAX suite's, on mamba2's smoke
        ctl = ctl_mod.Controller(n_nodes=2, node_cap=CONTROLLER_NODE,
                                 policy=policy, s=4.0, workdir=workdir,
                                 device=device)
        for name, gp in (("be_long_gp", 5), ("be_short_gp", 1)):
            ctl.submit(spec(name, cfg, False, np.array([8., 32., 8.]),
                            total_steps=40, gp_ticks=gp))
        ctl.submit(spec("te", cfg, True, np.array([4., 16., 4.]),
                        total_steps=2, submit_tick=1))
    else:
        ctl = ctl_mod.Controller(n_nodes=2, node_cap=CONTROLLER_NODE,
                                 policy=policy, s=4.0, steps_per_tick=2,
                                 workdir=workdir, device=device)
        for name, gp in (("be_long_gp", 5), ("be_short_gp", 1)):
            ctl.submit(spec(name, cfg, False, np.array([8., 32., 8.]),
                            total_steps=12, gp_ticks=gp))
        ctl.submit(spec("te", cfg, True, np.array([4., 16., 4.]),
                        total_steps=2, submit_tick=1))
        ctl.submit(spec("te2", cfg, True, np.array([4., 16., 8.]),
                        total_steps=2, submit_tick=6))
    t0 = time.perf_counter()
    ctl.run()
    ctl.wall_s = time.perf_counter() - t0
    return ctl


def phase_controller(torch, np):
    """The live controller on the card: real train jobs preempted and
    resumed through checkpoints; be0's losses across its preemption
    against its uninterrupted run, its first loss against the CPU's
    (:func:`be0_first_loss_bound`), each for the dense and the vlm smoke
    config; the TE's slowdown under fitgpp and fifo, the fleet's victim,
    the JAX suite's two mamba2 smoke cases, and every event log against
    the same specs' run on the CPU."""
    import shutil
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import controller as ctl_mod
    from repro_torch.kernels import ops
    cfg = get_smoke_config(CONTROLLER_ARCH)
    ssm_cfg = get_smoke_config(CONTROLLER_SSM_ARCH)
    vlm_cfg = get_smoke_config(CONTROLLER_VLM_ARCH)
    case_cfg = {"te_latency": ssm_cfg, "victim": ssm_cfg,
                "be_te_vlm": vlm_cfg}
    runs = (("be_te", "fitgpp"), ("be_te", "fifo"), ("fleet", "fitgpp"),
            ("te_latency", "fitgpp"), ("te_latency", "fifo"),
            ("victim", "fitgpp"), ("be_te_vlm", "fitgpp"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ctl_")
    zero_launches()
    out = {}
    threads = torch.get_num_threads()
    try:
        for dev in ("cuda", "cpu"):
            # a smoke step is hundreds of tiny operations: on the CPU one
            # thread runs them without waiting on a pool at each (the CPU
            # tests do the same); the event logs do not depend on it
            torch.set_num_threads(1 if dev == "cpu" else threads)
            for case, policy in runs:
                out[dev, case, policy] = controller_case(
                    np, ctl_mod, case_cfg.get(case, cfg), case, policy, dev,
                    os.path.join(tmp, f"{dev}-{case}-{policy}"))
        torch.set_num_threads(threads)
        launches = dict(ops.LAUNCHES)
        be = out["cuda", "be_te", "fitgpp"].jobs[0]
        be_vlm = out["cuda", "be_te_vlm", "fitgpp"].jobs[0]
        base = uninterrupted_losses(cfg, be.spec, ctl_mod)
        base_vlm = uninterrupted_losses(vlm_cfg, be_vlm.spec, ctl_mod)
        first = be0_first_loss_bound(torch, cfg, be.spec, ctl_mod)
        first_vlm = be0_first_loss_bound(torch, vlm_cfg, be_vlm.spec,
                                         ctl_mod)
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(tmp, ignore_errors=True)

    def log(c):
        return [{k: v for k, v in e.items() if k != "ckpt"}
                for e in c.events]

    def summary(c):
        return {"events": log(c), "wall_s": c.wall_s,
                "slowdown": {j.spec.name: c.slowdown(j) for j in c.jobs},
                "preempt_count": {j.spec.name: j.preempt_count
                                  for j in c.jobs},
                "flush_s": {j.spec.name: j.flush_s for j in c.jobs
                            if j.flush_s}}

    fleet = out["cuda", "fleet", "fitgpp"]
    te_fitgpp = out["cuda", "be_te", "fitgpp"].jobs[1]
    te_fifo = out["cuda", "be_te", "fifo"].jobs[1]
    sd_fitgpp = out["cuda", "be_te", "fitgpp"].slowdown(te_fitgpp)
    sd_fifo = out["cuda", "be_te", "fifo"].slowdown(te_fifo)
    first_victim = next((e["job"] for e in fleet.events
                         if e["ev"] == "preempt"), None)
    same_log = {f"{case}/{policy}": log(out["cuda", case, policy])
                == log(out["cpu", case, policy]) for case, policy in runs}
    ssm_te = {p: out["cuda", "te_latency", p] for p in ("fitgpp", "fifo")}
    ssm_sd = {p: c.slowdown(c.jobs[1]) for p, c in ssm_te.items()}
    victim = out["cuda", "victim", "fitgpp"]
    ssm_victim = next((e["job"] for e in victim.events
                       if e["ev"] == "preempt"), None)
    for f, case, job in ((first, "be_te", be), (first_vlm, "be_te_vlm",
                                                  be_vlm)):
        f["card"] = job.losses[0]
        f["cpu"] = out["cpu", case, "fitgpp"].jobs[0].losses[0]
        f["diff"] = abs(f["card"] - f["cpu"])
    emit({"phase": "controller", "arch": cfg.name, "dtype": cfg.dtype,
          "runs": {f"{case}/{policy}": summary(out["cuda", case, policy])
                   for case, policy in runs},
          "cpu_wall_s": {f"{case}/{policy}": out["cpu", case, policy].wall_s
                         for case, policy in runs},
          "be0_preempt_count": be.preempt_count,
          "be0_losses_bit_equal": be.losses == base,
          "te_slowdown": {"fitgpp": sd_fitgpp, "fifo": sd_fifo},
          "fleet_first_victim": first_victim,
          "event_log_equals_cpu": same_log, "launches": launches,
          "ssm_arch": ssm_cfg.name, "ssm_te_slowdown": ssm_sd,
          "ssm_first_victim": ssm_victim,
          "ssm_victim_preempt_count": {
              j.spec.name: j.preempt_count for j in victim.jobs},
          "be0_first_loss": first, "vlm_arch": vlm_cfg.name,
          "vlm_be0_preempt_count": be_vlm.preempt_count,
          "vlm_be0_losses_bit_equal": be_vlm.losses == base_vlm,
          "vlm_be0_first_loss": first_vlm})
    for job, b, what in ((be, base, cfg.name), (be_vlm, base_vlm,
                                                vlm_cfg.name)):
        check(job.preempt_count == 1,
              f"{what}: be0 preempted {job.preempt_count} times")
        check(job.losses == b, f"{what}: be0's losses across its preemption "
              "differ from its uninterrupted run")
    check(sd_fitgpp < sd_fifo, f"TE slowdown under fitgpp {sd_fitgpp} is "
          f"not below fifo's {sd_fifo}")
    check(first_victim == "be_short_gp" and
          fleet.jobs[0].preempt_count == 0,
          f"the fleet's victim was {first_victim}, not the short-GP job")
    check(all(same_log.values()), f"event logs differ from the CPU's: "
          f"{same_log}")
    for f, what in ((first, cfg.name), (first_vlm, vlm_cfg.name)):
        check(f["init_bit_equal"] and f["tokens_bit_equal"],
              f"{what}: be0's initial parameters or first batch differ "
              "between the card and the CPU")
        check(f["max_logit_diff"] <= f["logit_tol"], f"{what}: be0's first "
              f"logits on the card differ from the CPU's by "
              f"{f['max_logit_diff']} (tolerance {f['logit_tol']})")
        check(f["diff"] <= f["bound"], f"{what}: be0's first loss on the "
              f"card {f['card']} differs from the CPU's {f['cpu']} by more "
              f"than {f['bound']}")
    check(ssm_sd["fitgpp"] < ssm_sd["fifo"], f"{ssm_cfg.name}: TE slowdown "
          f"under fitgpp {ssm_sd['fitgpp']} is not below fifo's "
          f"{ssm_sd['fifo']}")
    check(victim.jobs[1].preempt_count == 1
          and victim.jobs[0].preempt_count == 0
          and ssm_victim == "be_short_gp",
          f"{ssm_cfg.name}: the victim was {ssm_victim}, not the short-GP "
          "job alone")


# be0's logits on the card against the CPU's (phase controller), both
# from equal initial parameters and tokens through the bf16 smoke
# config's training route: each within this many bf16 steps of the
# CPU's, a step taken at the CPU's largest |logit| (2^(e-7) for |z| in
# [2^e, 2^(e+1))). A tolerance fixed before the run: one step for the
# output head's own rounding, and three for what its input carries out
# of the smoke config's 2 layers, whose matrix products, residual adds
# and final norm each round to bf16 with other f32 summation orders on
# the two devices. A forward wrong by 2^-5 of max|logit| fails.
BE0_LOGIT_STEPS = 4


def uninterrupted_losses(cfg, spec, ctl_mod):
    """A controller job's losses trained on the card without a break:
    the same seed, batches and steps."""
    from repro_torch import trainer
    from repro_torch.data import make_batch
    st = trainer.init_train_state(cfg, spec.opt, ctl_mod.job_seed(spec.name),
                                  device="cuda")
    step, losses = trainer.make_train_step(cfg, spec.opt), []
    for i in range(spec.total_steps):
        st, m = step(st, make_batch(cfg, spec.batch, spec.seq_len, seed=1,
                                    step=i, device="cuda"))
        losses.append(float(m["loss"]))
    return losses


def be0_first_loss_bound(torch, cfg, spec, ctl_mod):
    """be0's initial parameters and first batch on the card and on the
    CPU (equal bit for bit, by construction), their logits through the
    training route, the logits' tolerance ``logit_tol``
    (:data:`BE0_LOGIT_STEPS` bf16 steps at the CPU's largest |logit|),
    and the bound the two first losses must keep, computed from the
    CPU's logits alone: 2 logit_tol + 2 (V + n) 2^-24 s, s the CPU's
    largest logsumexp plus its largest |logit| (what a token's CE can
    reach). A token's CE has gradient softmax - onehot in the logits,
    of L1 norm at most 2, so |dCE| <= 2 max|dz| for each token and for
    their mean; the second term bounds the f32 rounding of each side's
    logsumexp over V classes and mean over n tokens. The vlm's logits
    are its text positions' (the visual prefix is not predicted)."""
    from repro_torch import trainer
    from repro_torch.data import make_batch
    from repro_torch.models import dense, vlm
    out = {}
    for dev in ("cuda", "cpu"):
        st = trainer.init_train_state(cfg, spec.opt,
                                      ctl_mod.job_seed(spec.name),
                                      device=dev)
        b = make_batch(cfg, spec.batch, spec.seq_len, seed=1, step=0,
                       device=dev)
        with torch.no_grad():
            m = st["params"]
            if cfg.family == "vlm":
                x = dense.hidden_embedded(
                    cfg, m, vlm._embed_multimodal(cfg, m, b), train=True)
                z = dense.unembed(cfg, m, x)[:, cfg.vlm.n_visual_tokens:]
            else:
                z = dense.unembed(cfg, m, dense.hidden(cfg, m, b["tokens"],
                                                       train=True))
        out[dev] = ({k: v.detach().cpu() for k, v in m.state_dict().items()},
                    {k: v.cpu() for k, v in b.items()}, z.float().cpu())
    (pc, bc, zc), (pp, bp, zp) = out["cuda"], out["cpu"]
    tc = bp["tokens"]
    n_tok = tc.shape[0] * (tc.shape[1] - 1)
    z_max = float(zp.abs().max())
    logit_tol = BE0_LOGIT_STEPS * 2.0 ** (math.floor(math.log2(z_max)) - 7)
    # a token's CE is at most its logsumexp plus its largest |logit|
    scale = float(torch.logsumexp(zp, -1).abs().max()) + z_max
    return {"init_bit_equal": all(torch.equal(pc[k], pp[k]) for k in pp),
            "tokens_bit_equal": all(torch.equal(bc[k], bp[k]) for k in bp),
            "max_logit_diff": float((zc - zp).abs().max()),
            "max_abs_logit": z_max, "logit_tol": logit_tol,
            "bound": 2 * logit_tol
            + 2 * (cfg.vocab + n_tok) * 2.0 ** -24 * scale}


PHASES = ("build", "kernel", "flash_kernel", "ssd_kernel", "lru_kernel",
          "engine", "sweep_engine", "paper", "gang", "reference", "trace",
          "stream", "sweep", "serve", "serve_f32", "serve_card_vs_cpu",
          "serve_ssm", "serve_hybrid", "serve_moe", "serve_vlm",
          "serve_audio", "train", "train_ssm",
          "train_hybrid", "train_moe", "train_vlm", "train_audio",
          "controller")
# run only when named in --phases
EXTRA_PHASES = ("sweep_b1",)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + EXTRA_PHASES))
    phases = set(ap.parse_args(argv).phases.split(","))
    unknown = phases - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
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
        if "ssd_kernel" in phases:
            kernels.append(phase_ssd_kernel(torch))
        if "lru_kernel" in phases:
            kernels.append(phase_lru_kernel(torch))
        if "engine" in phases:
            phase_engine(torch)
        if "sweep_engine" in phases:
            phase_sweep_engine(torch, np)
        launches = {}         # kernel -> {main path: launches}
        runs = EngineRuns()
        if "paper" in phases:
            launches["schedule_step"] = {"paper": phase_paper(torch, np,
                                                              runs)}
        if "gang" in phases:
            launches.setdefault("schedule_step", {})["gang"] = \
                phase_gang(torch, np)
        if "reference" in phases:
            phase_reference(np, runs, stream="stream" in phases)
        if "trace" in phases:
            launches.setdefault("schedule_step", {})["trace"] = \
                phase_trace(torch, np, runs)
        if "stream" in phases:
            launches.setdefault("schedule_step", {})["stream"] = \
                phase_stream(torch, np, runs)
        if "sweep" in phases:
            launches.setdefault("schedule_step", {})["sweep"] = \
                phase_sweep(torch, np)
        if "sweep_b1" in phases:
            phase_sweep_b1(torch, np, runs)
        if "serve" in phases:
            launches["flash_attention"] = {"serve": phase_serve(torch)}
        if "serve_f32" in phases:
            phase_serve_f32(torch)
        if "serve_card_vs_cpu" in phases:
            phase_serve_card_vs_cpu(torch)
        for arch in (SSM_ARCH, HYBRID_ARCH):
            path = "serve_ssm" if arch == SSM_ARCH else "serve_hybrid"
            if path not in phases:
                continue
            for name, n in phase_serve_family(torch, arch).items():
                launches.setdefault(name, {})[path] = n
            phase_serve_family_f32(torch, arch)
            phase_serve_family_card_vs_cpu(torch, arch)
        for path, archs in NEW_FAMILY_PHASES.items():
            if path in phases:
                launches.setdefault("flash_attention", {})[path] = sum(
                    phase_serve_new_family(torch, arch) for arch in archs)
        if "train" in phases:
            phase_train(torch)
            phase_train_card_vs_cpu(torch)
        for path, arch, *run in TRAIN_FAMILIES:
            if path not in phases:
                continue
            for name, n in phase_train_family(torch, path, arch,
                                              *run).items():
                if n:
                    launches.setdefault(name, {})[path] = n
            if arch in (SSM_ARCH, HYBRID_ARCH):
                phase_train_family_card_vs_cpu(torch, arch)
        if "controller" in phases:
            phase_controller(torch, np)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for k in kernels:
        k.pop("timed_shape", None)
        by_path = launches.get(k["name"])
        k["launches"] = sum(by_path.values()) if by_path else None
        k["launches_by_path"] = by_path
    total = time.perf_counter() - t0
    emit({"phase": "total", "seconds": total,
          "paper_wall_s": runs.paper_wall_s})
    emit({"kernels": kernels})
    print(smi)
    print(f"chip_smoke: {total:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

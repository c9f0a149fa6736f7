"""Online preemption controller: FitGpp driving real PyTorch training
jobs (counterpart of ``repro.core.controller``).

The simulator reproduces the paper's numbers; this module shows the
mechanism on live jobs. A small in-process cluster runs real train
steps for every RUNNING job each tick; preempting a victim starts its
grace period, at whose end the job's train state (parameters, AdamW
moments and step; the data cursor is its ``steps_done``) is flushed
through ``repro_torch.checkpoint`` and freed. The grace period is sized
from the live state's bytes. A resumed job continues bit for bit: its
loss trajectory equals an uninterrupted run's.

Scheduling is the numpy reference engine's, literally: the controller
drives the port's :class:`~repro_torch.core.engine.SchedulerCore`,
which owns the strict-FIFO BE queue with head-of-line blocking, the TE
lane, requeue-on-top for victims, the preemption cap P, grace-aware
triggering and gang placement. This driver owns only the training side:
initializing and stepping train states, the flush on vacate, the
restore on resume, and grace periods from live state bytes. Scheduling
does not depend on the device the jobs train on.

One departure from the JAX controller: a job's initial parameters come
from ``zlib.crc32`` of its name (:func:`job_seed`), where JAX takes
Python's ``hash``, which ``PYTHONHASHSEED`` changes between processes.
"""
from __future__ import annotations

import os
import tempfile
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from repro_torch import device as _device
from repro_torch import trainer
from repro_torch.checkpoint import (estimate_grace_period, load_pytree,
                                    save_pytree)
from repro_torch.configs.base import PAPER_P, PAPER_S, ModelConfig
from repro_torch.core import policy_registry
from repro_torch.core.engine import ClusterState, CoreHooks, SchedulerCore
from repro_torch.core.types import DONE, GRACE, QUEUED, RUNNING
from repro_torch.core.types import NOT_ARRIVED as PENDING
from repro_torch.data import make_batch
from repro_torch.optim import AdamWConfig


def job_seed(name: str) -> int:
    """The seed of a job's initial parameters: stable across processes."""
    return zlib.crc32(name.encode()) % (1 << 31)


@dataclass
class JobSpec:
    name: str
    cfg: ModelConfig                  # smoke-scale model config
    is_te: bool
    demand: np.ndarray                # (cpu, ram, gpu) PER NODE
    total_steps: int
    batch: int = 4
    seq_len: int = 32
    submit_tick: int = 0
    n_nodes: int = 1                  # gang width (all-or-nothing)
    opt: AdamWConfig = field(default_factory=lambda: AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=1000))
    gp_ticks: Optional[int] = None    # None -> estimated from state size


@dataclass
class Job:
    spec: JobSpec
    status: int = PENDING
    steps_done: int = 0
    node: int = -1
    preempt_count: int = 0
    grace_left: int = 0
    state: Optional[dict] = None      # live train state (when scheduled)
    ckpt_path: Optional[str] = None
    losses: List[float] = field(default_factory=list)
    submit_time: int = -1
    finish_time: int = -1
    run_ticks: int = 0
    flush_s: List[float] = field(default_factory=list)   # per vacate
    _step_fn: Optional[Callable] = None

    @property
    def gp(self) -> int:
        if self.spec.gp_ticks is not None:
            return self.spec.gp_ticks
        if self.state is None:
            return 1
        return estimate_grace_period(self.state,
                                     storage_bw_bytes_per_s=2e9)


class Controller:
    """Live jobs on ``n_nodes`` nodes of ``node_cap``, training on
    ``device`` (default: the current CUDA device; raises without one).
    Checkpoints go to ``workdir`` (default: a new temporary directory)."""

    def __init__(self, *, n_nodes: int = 2,
                 node_cap=(32.0, 256.0, 8.0),
                 policy: str = "fitgpp", s: float = PAPER_S,
                 max_preemptions: int = PAPER_P,
                 steps_per_tick: int = 2,
                 workdir: Optional[str] = None,
                 seed: int = 0, device=None):
        self.device = _device.resolve(device)
        self.node_cap = np.asarray(node_cap, float)
        self.policy = policy_registry.make(policy, s=s)
        self.P = max_preemptions
        self.steps_per_tick = steps_per_tick
        self.workdir = workdir or tempfile.mkdtemp(prefix="repro_torch_ctl_")
        self.rng = np.random.default_rng(seed)
        self.jobs: List[Job] = []
        self.t = 0
        self.events: List[dict] = []
        self.core = SchedulerCore(
            cluster=ClusterState(n_nodes, self.node_cap),
            policy=self.policy,
            max_preemptions=max_preemptions,
            rng=self.rng,
            gp_of=self._gp_of,
            remaining_of=self._remaining_of,
            hooks=CoreHooks(on_start=self._on_start,
                            on_signal=self._on_signal,
                            on_vacate=self._on_vacate,
                            on_finish=self._on_finish),
        )
        os.makedirs(self.workdir, exist_ok=True)

    # -- core accessors: live quantities the core cannot own -----------------

    def _gp_of(self, ids):
        if np.ndim(ids) == 0:
            return self.jobs[int(ids)].gp
        return np.asarray([self.jobs[int(i)].gp for i in np.asarray(ids)],
                          float)

    def _remaining_of(self, ids):
        return np.asarray(
            [self.jobs[int(i)].spec.total_steps - self.jobs[int(i)].steps_done
             for i in np.atleast_1d(np.asarray(ids))], float)

    # -- job lifecycle -------------------------------------------------------

    def submit(self, spec: JobSpec) -> Job:
        job = Job(spec=spec)
        self.jobs.append(job)
        self.core.add_job(spec.demand, spec.is_te, spec.n_nodes)
        return job

    def _init_state(self, job: Job) -> None:
        spec = job.spec
        if job.ckpt_path is not None:
            template = trainer.init_train_state(spec.cfg, spec.opt, 0,
                                                device=self.device)
            job.state = load_pytree(template, job.ckpt_path)
        elif job.state is None:
            job.state = trainer.init_train_state(
                spec.cfg, spec.opt, job_seed(spec.name), device=self.device)
        if job._step_fn is None:
            job._step_fn = trainer.make_train_step(spec.cfg, spec.opt)

    # -- core hooks: the training side of each transition --------------------

    def _on_start(self, j: int, nodes: np.ndarray, t: int) -> None:
        job = self.jobs[j]
        job.status = RUNNING
        job.node = int(nodes[0])
        self._init_state(job)
        self.events.append({"t": t, "ev": "start", "job": job.spec.name})

    def _on_signal(self, j: int, te: int, t: int) -> None:
        job = self.jobs[j]
        job.status = GRACE
        job.preempt_count = int(self.core.preempt_count[j])
        job.grace_left = int(self.core.grace_left[j])
        self.events.append({"t": t, "ev": "preempt",
                            "job": job.spec.name,
                            "for": self.jobs[te].spec.name,
                            "gp": job.grace_left})

    def _on_vacate(self, j: int, t: int) -> None:
        # grace period over: the checkpoint is flushed and memory freed
        job = self.jobs[j]
        job.ckpt_path = os.path.join(
            self.workdir, f"{job.spec.name}.{job.preempt_count}.npz")
        t0 = time.perf_counter()
        save_pytree(job.state, job.ckpt_path)
        job.flush_s.append(time.perf_counter() - t0)
        job.state = None
        job.node = -1
        job.status = QUEUED
        self.events.append({"t": t, "ev": "vacate",
                            "job": job.spec.name,
                            "ckpt": job.ckpt_path})

    def _on_finish(self, j: int, t: int) -> None:
        job = self.jobs[j]
        job.node = -1
        job.status = DONE
        job.finish_time = t
        self.events.append({"t": t, "ev": "done", "job": job.spec.name})

    # -- one tick ------------------------------------------------------------

    def tick(self) -> None:
        t = self.t
        core = self.core
        # arrivals
        for j, job in enumerate(self.jobs):
            if job.status == PENDING and job.spec.submit_tick <= t:
                core.enqueue(j)
                job.status = QUEUED
                job.submit_time = t
        # grace expiry, then the shared schedule pass (TE lane + BE FIFO)
        core.expire_grace(t)
        core.schedule(t)
        # run real train steps for every RUNNING job
        for j, job in enumerate(self.jobs):
            if job.status != RUNNING:
                continue
            for _ in range(self.steps_per_tick):
                if job.steps_done >= job.spec.total_steps:
                    break
                batch = make_batch(job.spec.cfg, job.spec.batch,
                                   job.spec.seq_len, seed=1,
                                   step=job.steps_done, device=self.device)
                job.state, m = job._step_fn(job.state, batch)
                job.losses.append(float(m["loss"]))
                job.steps_done += 1
            job.run_ticks += 1
            if job.steps_done >= job.spec.total_steps:
                core.finish(j, t)
        core.tick_clocks()
        for j in core.grace:
            self.jobs[j].grace_left = int(core.grace_left[j])
        self.t += 1

    def run(self, max_ticks: int = 10_000) -> None:
        while any(j.status != DONE for j in self.jobs):
            self.tick()
            if self.t > max_ticks:
                raise RuntimeError("controller did not converge")

    # -- metrics --------------------------------------------------------------

    def slowdown(self, job: Job) -> float:
        turnaround = job.finish_time - job.spec.submit_tick
        exec_ticks = max(job.run_ticks, 1)
        return 1.0 + max(turnaround - exec_ticks, 0) / exec_ticks

"""Trial-axis sharding for the sweep fabric: one process per device.

The counterpart of the JAX package's ``sharding/trials.py`` and of the
mesh path of its ``sweep_fabric.run_table``, where the trial table is
padded with sentinel trials to a multiple of the mesh, each device runs
its shard under ``shard_map``, and the results come back in trial order
with the padding dropped. Here :func:`shard_table` pads the table with
``sweep_fabric.pad_table`` and cuts it into equal contiguous shards,
and a :class:`ShardPool` runs each shard through the one-device
``sweep_fabric.run_table`` in a process of its own on its own device,
then gathers the per-trial stats and ``engine_stats`` in trial order.

Processes, not threads: the batched engine is host-bound (a host read
every few launches), so threads would serialise on the interpreter
lock. The processes are started with ``spawn`` (never ``fork`` after
CUDA is initialised) and kept for the pool's life, so a grid of several
configs pays for their start (an interpreter, ``import torch``, a CUDA
context) once. Each shard travels to its process, and its results
back, through the process's ``multiprocessing`` pipe as numpy arrays.

A trial's result does not depend on its shard: the batched engine's
draws are counter-based on (trial seed, the lane's draw count, job), so
a sharded run equals the one-device run bit for bit.
"""
from __future__ import annotations

import multiprocessing
import os
import traceback
from dataclasses import fields
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import sweep_fabric
from repro_torch.core.sim_torch import Jobs

# seconds a worker gets to exit after the pool asks it to
_JOIN_S = 30.0


def shard_table(table: sweep_fabric.TrialTable, n: int
                ) -> List[sweep_fabric.TrialTable]:
    """The table padded with sentinel trials to a multiple of ``n``
    (``sweep_fabric.pad_table``) and cut into ``n`` equal contiguous
    shards, in trial order."""
    padded = sweep_fabric.pad_table(table, n)
    per = int(padded.s.shape[0]) // n

    def part(x, i):
        return x[i * per:(i + 1) * per]

    return [sweep_fabric.TrialTable(
        jobs=padded.jobs.map(lambda x, i=i: part(x, i)),
        s=part(padded.s, i), P=part(padded.P, i), seed=part(padded.seed, i),
        n_valid=table.n_valid) for i in range(n)]


def _to_arrays(table: sweep_fabric.TrialTable) -> dict:
    jobs = {f.name: getattr(table.jobs, f.name) for f in fields(Jobs)}
    return {"jobs": {k: None if v is None else v.numpy()
                     for k, v in jobs.items()},
            "s": table.s.numpy(), "P": table.P.numpy(),
            "seed": table.seed.numpy(), "n_valid": table.n_valid}


def _from_arrays(a: dict) -> sweep_fabric.TrialTable:
    return sweep_fabric.TrialTable(
        jobs=Jobs(**{k: None if v is None else torch.from_numpy(v)
                     for k, v in a["jobs"].items()}),
        s=torch.from_numpy(a["s"]), P=torch.from_numpy(a["P"]),
        seed=torch.from_numpy(a["seed"]), n_valid=a["n_valid"])


def _serve(conn, device: str, threads: Optional[int]) -> None:
    """A worker: run each shard it is sent on ``device`` until it is
    sent ``None``; reply ``("ok", (stats, engine_stats))`` or
    ``("error", traceback)``."""
    if threads:
        torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(device)
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                return
            cfg, arrays, time_mode, out = msg
            try:
                res = sweep_fabric.run_table(cfg, _from_arrays(arrays),
                                             time_mode=time_mode, out=out,
                                             device=device)
                conn.send(("ok", (res.stats, res.engine_stats)))
            except Exception:       # reported to the parent, which raises
                conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def _gather_engine_stats(shards: Sequence[dict], T: int) -> Dict:
    """The shards' engine counters: per-lane arrays concatenated in
    trial order (padding dropped), counters summed, and each shard's
    counters under ``"shards"``."""
    out: Dict = {}
    for k, v in shards[0].items():
        if isinstance(v, np.ndarray):
            out[k] = np.concatenate([s[k] for s in shards])[:T]
        else:
            out[k] = sum(s[k] for s in shards)
    out["shards"] = [{k: v for k, v in s.items()
                      if not isinstance(v, np.ndarray)} for s in shards]
    return out


class ShardPool:
    """One spawned worker process per entry of ``devices`` (device
    names, a name may repeat: two processes can share a card), kept
    until :meth:`close`. Use as a context manager."""

    def __init__(self, devices: Sequence[str]):
        self.devices = [str(d) for d in devices]
        if len(self.devices) < 1:
            raise ValueError("a ShardPool needs at least one device")
        n_cpu = sum(torch.device(d).type == "cpu" for d in self.devices)
        # a CPU worker's intra-op threads: the caller's own count, at most
        # the worker's share of the cores
        threads = max(1, min(torch.get_num_threads(),
                             (os.cpu_count() or 1) // n_cpu)) \
            if n_cpu else None
        ctx = multiprocessing.get_context("spawn")
        self._conns, self._procs = [], []
        try:
            for dev in self.devices:
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_serve, daemon=True, name=f"trial-shard-{dev}",
                    args=(child, dev,
                          threads if torch.device(dev).type == "cpu"
                          else None))
                proc.start()
                child.close()
                self._conns.append(parent)
                self._procs.append(proc)
        except BaseException:
            self.close()
            raise

    def run(self, cfg, table: sweep_fabric.TrialTable, *,
            time_mode: Optional[str] = None,
            out: str = "percentiles") -> sweep_fabric.SweepResult:
        """Run ``table`` under ``cfg``: padded and cut into one shard per
        device (:func:`shard_table`), each shard a one-device
        ``run_table`` in its worker, the results gathered in trial
        order with the sentinel rows dropped."""
        if time_mode is None:
            time_mode = cfg.time_mode
        T, n = int(table.s.shape[0]), len(self.devices)
        shards = shard_table(table, n)
        for dev, conn, shard in zip(self.devices, self._conns, shards):
            try:
                conn.send((cfg, _to_arrays(shard), time_mode, out))
            except (BrokenPipeError, OSError) as e:
                raise RuntimeError(f"the shard worker on {dev} is gone "
                                   f"({e})") from e
        replies = []
        for dev, conn in zip(self.devices, self._conns):
            try:
                replies.append((dev,) + conn.recv())
            except EOFError:
                replies.append((dev, "error", "the worker process died"))
        failed = [f"shard on {dev}:\n{r}" for dev, kind, r in replies
                  if kind != "ok"]
        if failed:
            raise RuntimeError("sharded sweep failed:\n" + "\n".join(failed))
        results = [r for _, _, r in replies]
        stats = {k: np.concatenate([r[0][k] for r in results])[:T]
                 for k in results[0][0]}
        return sweep_fabric.SweepResult(
            stats=stats, n_trials=T, n_padded=n * int(shards[0].s.shape[0])
            - T, n_devices=n, out=out, time_mode=time_mode,
            engine_stats=_gather_engine_stats([r[1] for r in results], T))

    def close(self) -> None:
        """Ask every worker to exit and wait for it (killing one that
        does not exit in time)."""
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(_JOIN_S)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []

    def __enter__(self) -> "ShardPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

"""Training driver: an end-to-end train loop for any ``--arch`` (the
dense, moe, ssm, hybrid, audio and vlm families).

    python -m repro_torch.launch.train --arch stablelm-12b [--smoke] \\
        [--steps 20] [--batch 4] [--seq-len 64] [--microbatches 1] \\
        [--lr 1e-3] [--seed 0] [--log-every 5] [--device cuda]

Runs real steps on the current CUDA device unless ``--device`` names
another (``--device cpu`` runs the plain PyTorch path on the CPU).
Counterpart of ``repro.launch.train``, without its mesh and sharding
plan (one device). :func:`train` is the loop ``main`` wraps; it also
takes a config directly (a depth-cut one, say), an AdamW config of the
caller's (bfloat16 moments, say; the CLI keeps JAX's float32 ones) and
can resume from a state at a given step.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, NamedTuple, Optional

import torch

from repro_torch import device as _device
from repro_torch import models, trainer
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import make_batch
from repro_torch.optim import AdamWConfig


class TrainResult(NamedTuple):
    state: dict
    losses: List[float]          # one per step run, in order
    step_s: List[float]          # each step's wall s, ending in a sync


def opt_config(steps: int, lr: float) -> AdamWConfig:
    """The launcher's AdamW: warmup over a tenth of the steps (at least
    one), cosine decay to 0 at ``steps``."""
    return AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                       total_steps=steps)


def train(cfg, *, steps: int = 20, batch: int = 4, seq_len: int = 64,
          microbatches: int = 1, lr: float = 1e-3, seed: int = 0,
          log_every: int = 5, device=None, state: Optional[dict] = None,
          start: int = 0, opt_cfg: Optional[AdamWConfig] = None,
          on_step: Optional[Callable[[int, dict, dict], None]] = None,
          log: Optional[Callable[[str], None]] = print) -> TrainResult:
    """Steps ``start`` .. ``steps - 1`` of a run of ``steps``: batch ``i``
    is ``make_batch(cfg, batch, seq_len, seed, i)`` (with the audio and
    vlm families' embeddings). ``opt_cfg`` replaces
    ``opt_config(steps, lr)``; ``state`` resumes a run (default: a new
    state from ``seed``); ``on_step(i, state, metrics)`` runs after each
    step."""
    dev = _device.resolve(device)
    ocfg = opt_cfg if opt_cfg is not None else opt_config(steps, lr)
    if state is None:
        state = trainer.init_train_state(cfg, ocfg, seed, device=dev)
    step_fn = trainer.make_train_step(cfg, ocfg, microbatches)
    losses, step_s = [], []
    for i in range(start, steps):
        b = make_batch(cfg, batch, seq_len, seed, i, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))      # waits for the step
        step_s.append(time.perf_counter() - t0)
        if on_step is not None:
            on_step(i, state, m)
        if log is not None and (i % log_every == 0 or i == steps - 1):
            log(f"step {int(m['step']):5d}  loss {losses[-1]:.4f}  "
                f"({step_s[-1]:.2f}s/step)")
    return TrainResult(state, losses, step_s)


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} params={models.count_params(cfg) / 1e6:.1f}M "
          f"device={dev}")
    res = train(cfg, steps=args.steps, batch=args.batch,
                seq_len=args.seq_len, microbatches=args.microbatches,
                lr=args.lr, seed=args.seed, log_every=args.log_every,
                device=dev)
    print("done")
    return res


if __name__ == "__main__":
    main()

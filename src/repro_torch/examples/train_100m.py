"""End-to-end training driver: a ~100M-parameter dense LM for a few
hundred steps on one device (the same code path as
``repro_torch.launch.train`` and the dry-run's step).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_100m
          [--steps 300] [--batch 8] [--seq-len 256] [--device cpu]

It trains on ``--device`` (the current CUDA device by default; it raises
without one).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as _device
from repro_torch import models, trainer
from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.optim import AdamWConfig

# ~100M params: the stablelm family scaled down (the JAX example's)
WIDTHS = dict(n_layers=8, d_model=768, n_heads=12, n_kv_heads=4,
              head_dim=64, d_ff=2048, vocab=32_000)


def main(argv=None, **widths) -> str:
    """``widths`` overrides entries of :data:`WIDTHS` (tests run a
    narrower model)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    cfg = get_config("stablelm-12b").replace(
        **{**WIDTHS, **widths}, dtype="float32", remat="none")
    n = models.count_params(cfg)
    lines = [f"model: {cfg.name}-100m  params={n / 1e6:.1f}M  "
             f"device={dev}"]
    print(lines[0])

    ocfg = AdamWConfig(lr=6e-4, warmup_steps=args.steps // 10,
                       total_steps=args.steps)
    state = trainer.init_train_state(cfg, ocfg, 0, device=dev)
    step = trainer.make_train_step(cfg, ocfg)

    t0 = time.perf_counter()
    first = None
    for i in range(args.steps):
        batch = make_batch(cfg, args.batch, args.seq_len, 0, i, device=dev)
        state, m = step(state, batch)
        loss = float(m["loss"])          # reads the device: steps timed
        first = first if first is not None else loss
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            dt = (time.perf_counter() - t0) / (i + 1)
            lines.append(f"step {i:4d}  loss {loss:.4f}  "
                         f"({dt * 1e3:.1f} ms/step)")
            print(lines[-1])
    wall = time.perf_counter() - t0
    lines.append(f"loss: {first:.3f} -> {loss:.3f} over {args.steps} steps, "
                 f"{wall / args.steps * 1e3:.2f} ms/step")
    if dev.type == "cuda":
        lines[-1] += (f", peak device "
                      f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    print(lines[-1])
    assert loss < first, "training must make progress"
    return "\n".join(lines)


if __name__ == "__main__":
    main()

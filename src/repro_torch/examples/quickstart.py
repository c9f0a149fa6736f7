"""Quickstart: the three layers of this repo in about a minute.

1. The paper (FitGpp): simulate a cluster and see TE latency collapse.
2. The substrate: real train steps for an assigned architecture.
3. The mechanism: preempt a live training job with a grace period and
   resume it bit-exactly from its checkpoint.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
          [--device cpu]

Everything runs on ``--device`` (the current CUDA device by default; it
raises without one): the engine's fused schedule pass is the CUDA
kernel there, and the train steps and the live jobs run on it too.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np

from repro_torch import api, trainer
from repro_torch import device as _device
from repro_torch.configs import get_smoke_config
from repro_torch.core import metrics
from repro_torch.core.controller import Controller, JobSpec
from repro_torch.data import make_batch
from repro_torch.optim import AdamWConfig


def part1_scheduler(device, n_jobs: int) -> list:
    lines = ["=" * 64,
             "1) FitGpp vs FIFO on a synthetic workload (paper Table 1)"]
    # one facade call per (scenario, policy, engine) triple; both runs
    # share the same generated jobset (compare_policies builds it once)
    results = api.compare_policies(("fifo", "fitgpp"), n_jobs=n_jobs,
                                   device=device)
    rows = {name: r.table for name, r in results.items()}
    lines.append(metrics.format_table(rows))
    drop = 1 - rows["fitgpp"]["TE"]["p95"] / rows["fifo"]["TE"]["p95"]
    lines.append(f"-> TE p95 slowdown cut by {drop * 100:.1f}% "
                 "(paper: 96.6%)\n")
    return lines


def part2_train_step(device, steps: int) -> list:
    lines = ["=" * 64,
             "2) Real train steps on a reduced mixtral (MoE) config"]
    cfg = get_smoke_config("mixtral-8x22b")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    state = trainer.init_train_state(cfg, ocfg, 0, device=device)
    step = trainer.make_train_step(cfg, ocfg)
    for i in range(steps):
        state, m = step(state, make_batch(cfg, 4, 64, seed=0, step=i,
                                          device=device))
        if i % 3 == 0:
            lines.append(f"   step {i}: loss {float(m['loss']):.4f}")
    lines.append("")
    return lines


def part3_preemption(device, be_steps: int) -> list:
    lines = ["=" * 64,
             "3) Preempt a live job (grace period -> checkpoint -> resume)"]
    cfg = get_smoke_config("mamba2-1.3b")
    with tempfile.TemporaryDirectory() as workdir:
        ctl = Controller(n_nodes=1, node_cap=(32., 256., 8.),
                         policy="fitgpp", steps_per_tick=2, workdir=workdir,
                         device=device)
        be = ctl.submit(JobSpec("train-be", cfg, False,
                                np.array([8., 32., 8.]),
                                total_steps=be_steps))
        ctl.submit(JobSpec("debug-te", cfg, True, np.array([4., 16., 8.]),
                           total_steps=2, submit_tick=2))
        ctl.run()
    for e in ctl.events:
        lines.append(f"   t={e['t']:2d}  {e['ev']:8s} {e['job']}"
                     + (f" (gp={e['gp']})" if "gp" in e else ""))
    lines.append(f"-> BE job preempted {be.preempt_count}x, finished with "
                 f"a continuous loss curve ({len(be.losses)} steps).")
    return lines


def main(argv=None, *, n_jobs: int = 2048, train_steps: int = 10,
         be_steps: int = 16) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    lines = (part1_scheduler(dev, n_jobs) + part2_train_step(dev, train_steps)
             + part3_preemption(dev, be_steps))
    text = "\n".join(lines)
    print(text)
    return text


if __name__ == "__main__":
    main()

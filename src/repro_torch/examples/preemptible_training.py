"""End-to-end preemptible-training driver (the paper's mechanism, live).

A 2-node mini-cluster runs REAL training jobs for several assigned
architectures as best-effort work; short trial-and-error jobs arrive and
FitGpp preempts the victim whose (size, grace-period) score is lowest,
grace periods estimated from each job's true checkpoint size. Victims
flush their train state through ``repro_torch.checkpoint`` and later
resume with bit-exact loss curves.

Run:  PYTHONPATH=src python -m repro_torch.examples.preemptible_training
          [--device cpu]

The jobs train on ``--device`` (the current CUDA device by default; it
raises without one).
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np

from repro_torch import device as _device
from repro_torch.configs import get_smoke_config
from repro_torch.core.controller import Controller, JobSpec


def fleet(ctl: Controller, be_steps: int, te_steps: int) -> None:
    """The JAX example's four jobs."""
    # best-effort training fleet: two different architecture families
    ctl.submit(JobSpec("be-mamba", get_smoke_config("mamba2-1.3b"),
                       False, np.array([8., 64., 8.]), total_steps=be_steps))
    ctl.submit(JobSpec("be-moe", get_smoke_config("qwen3-moe-30b-a3b"),
                       False, np.array([8., 64., 8.]), total_steps=be_steps))
    # trial-and-error jobs arrive while the cluster is full
    ctl.submit(JobSpec("te-debug-1", get_smoke_config("stablelm-12b"),
                       True, np.array([4., 16., 8.]), total_steps=te_steps,
                       submit_tick=2))
    ctl.submit(JobSpec("te-debug-2", get_smoke_config("internvl2-2b"),
                       True, np.array([4., 16., 4.]), total_steps=te_steps,
                       submit_tick=6))


def main(argv=None, *, be_steps: int = 30, te_steps: int = 3) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ctl_") as workdir:
        ctl = Controller(n_nodes=2, node_cap=(32., 256., 8.),
                         policy="fitgpp", s=4.0, steps_per_tick=2,
                         workdir=workdir, device=dev)
        fleet(ctl, be_steps, te_steps)
        ctl.run()

    lines = ["event log:"]
    for e in ctl.events:
        extra = f" for {e['for']}" if "for" in e else ""
        extra += f" (gp={e['gp']})" if "gp" in e else ""
        lines.append(f"  t={e['t']:3d} {e['ev']:8s} {e['job']}{extra}")
    lines.append("\nper-job outcome:")
    for job in ctl.jobs:
        kind = "TE" if job.spec.is_te else "BE"
        lines.append(f"  {job.spec.name:12s} [{kind}] "
                     f"steps={job.steps_done:3d} "
                     f"preempted={job.preempt_count} slowdown="
                     f"{ctl.slowdown(job):.2f} "
                     f"final_loss={job.losses[-1]:.3f}")
    text = "\n".join(lines)
    print(text)
    return text


if __name__ == "__main__":
    main()

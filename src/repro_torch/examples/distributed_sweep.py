"""Fig. 4 sensitivity sweep on the port's sweep fabric.

Every (s, seed) trial is an independent simulation, so the whole grid
flattens into ONE trial table that the batched engine runs in lockstep
(DESIGN.md §11). Where the JAX example ``shard_map``s the table over a
device mesh, the port runs one process per device:
``launch.mesh.mesh_for_sweep`` names the devices (one unless
``--devices`` asks for more) and ``sharding/trials.py`` pads the table
with sentinel trials and runs each shard in its own process, with the
one-device results bit for bit.

Run:  PYTHONPATH=src python -m repro_torch.examples.distributed_sweep
          [--devices N] [--device cpu]

The trials run on ``--device`` (the current CUDA device by default; it
raises without one); ``--devices N`` on the CPU starts N host processes.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch import device as _device
from repro_torch.configs.cluster import SimConfig, WorkloadSpec
from repro_torch.core import sweep
from repro_torch.launch.mesh import available_devices, mesh_for_sweep

S_VALS = (0.0, 1.0, 2.0, 4.0, 8.0)
SEEDS = (0, 1)


def grid(n_jobs: int = 1024, s_vals: Sequence[float] = S_VALS,
         seeds: Sequence[int] = SEEDS, devices: Optional[int] = None,
         device=None) -> tuple:
    """-> (``sweep.sensitivity_grid``'s arrays, devices used): fitgpp at
    P = 1 and gp_scale 2.0, as the JAX example."""
    dev = _device.resolve(device)
    cfg = SimConfig(workload=WorkloadSpec(n_jobs=n_jobs, gp_scale=2.0),
                    policy="fitgpp", max_preemptions=1)
    n_trials = len(s_vals) * len(seeds)
    mesh = mesh_for_sweep(n_trials, devices, dev)   # None: one device
    n_dev = 1 if mesh is None else len(mesh)
    out = sweep.sensitivity_grid(cfg, n_jobs, s_vals, seeds, devices=n_dev,
                                 device=dev)
    return out, n_dev


def main(argv=None, *, n_jobs: int = 1024,
         s_vals: Sequence[float] = S_VALS,
         seeds: Sequence[int] = SEEDS) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="devices to shard the table over, one process "
                         "each (default: one)")
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    out, n_dev = grid(n_jobs, s_vals, seeds, args.devices, dev)

    n_trials = len(s_vals) * len(seeds)
    lines = [f"Fig. 4 — FitGpp sensitivity to s (GP weight), gp_scale=2.0 "
             f"({n_trials} trials on {n_dev}/{available_devices(dev)} "
             "devices)",
             f"{'s':>5s} | {'TE p95':>8s} {'TE p99':>8s} | {'BE p50':>8s} "
             f"| {'interval p50':>12s}"]
    for i, s in enumerate(s_vals):
        te95 = np.nanmean(out["te_slowdown"][i, :, 1])
        te99 = np.nanmean(out["te_slowdown"][i, :, 2])
        be50 = np.nanmean(out["be_slowdown"][i, :, 0])
        iv50 = np.nanmean(out["intervals"][i, :, 0])
        lines.append(f"{s:5.1f} | {te95:8.2f} {te99:8.2f} | {be50:8.2f} "
                     f"| {iv50:12.1f}")
    lines.append("\npaper Fig. 4: TE slowdown falls with s and saturates "
                 "by s in [4, 8]; BE slowdown is s-independent.")
    text = "\n".join(lines)
    print(text)
    return text


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the schedule-pass kernel of this checkout against another's on
one NVIDIA GPU, in turns.

    python3 kernel_ab.py OTHER_ROOT [--pairs 2]

OTHER_ROOT is another checkout of the repo (for instance the parent
commit unpacked with ``git archive``). Each side runs in a process of
its own, which builds that checkout's ``schedule_step.cu`` and times one
launch (median of chip_smoke's queued CUDA-event windows) at the pool
pass of the stream engine (1, 2688, 84), phase paper's (1, 65536, 84)
and the sweep's (20, 65536, 84), on chip_smoke's random integer passes
without ``akey``; a side whose wrapper takes ``akey`` also times a
tie-heavy pool pass with and without it. The order is other, this,
this, other per pair. Prints one JSON line per run, then the card's
name and power limit. Imports no JAX.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(1, 32 * 84, 84), (1, 2 ** 16, 84), (20, 2 ** 16, 84)]


def time_side(root: str) -> dict:
    """Runs in the side's process: ``root``'s package, this checkout's
    chip_smoke helpers."""
    sys.path[:0] = [os.path.join(root, "src")]
    sys.path.append(ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import schedule_step as ss
    out = {"root": root}
    for shape in SHAPES:
        args = cs.batched_args(torch, np, *shape, 99)
        out[str(shape)] = cs.time_kernel_ms(torch, ss, args)
    if "akey" in ss.schedule_step_cuda.__code__.co_varnames:
        args = cs.batched_args(torch, np, *SHAPES[0], 299, "ties")
        out["ties_akey"] = cs.time_kernel_ms(torch, ss, args)
        out["ties_no_akey"] = cs.time_kernel_ms(torch, ss, args[:-1])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--side", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.side:
        print(json.dumps(time_side(args.side)), flush=True)
        return 0
    other = os.path.abspath(args.other)
    order = []
    for p in range(args.pairs):
        order += [other, ROOT] if p % 2 == 0 else [ROOT, other]
    for side in order:
        out = subprocess.run([sys.executable, __file__, args.other,
                              "--side", side], capture_output=True,
                             text=True, timeout=600)
        if out.returncode != 0:
            print(out.stderr[-2000:], file=sys.stderr)
            return 1
        print(out.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

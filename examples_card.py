#!/usr/bin/env python3
"""Run the port's seven examples on the card, each in a fresh process,
at their default sizes (the JAX examples'), and report each one's wall
seconds and kernel launches.

    python3 examples_card.py [--only cluster_simulation,...]
        [--out build/examples_card]

Each example runs as ``repro_torch.examples.<name>.main(argv)`` in a
child process; the child prints the example's own report, then one JSON
line ``{"example", "argv", "main_s", "launches"}``: the seconds of
``main`` (the CUDA device synchronized after it) and the launches of
each hand-written kernel in it (``kernels.ops.LAUNCHES``). The parent
adds the process's wall seconds and writes each report to
``<out>/<name>.log``. Its first line is the card's name and power
limit (``nvidia-smi``); its last, a JSON summary. Exits 1 if an example
fails. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# (example, argv): the JAX examples' sizes, each on its defaults (the
# torch engine on the card)
RUNS = (("cluster_simulation", []),
        ("trace_replay", []),
        ("stream_replay", ["--parity"]),
        ("distributed_sweep", []),
        ("quickstart", []),
        ("preemptible_training", []),
        ("train_100m", []))

_CHILD = r"""
import importlib, json, sys, time
import torch
from repro_torch.kernels import ops
name, argv = sys.argv[1], json.loads(sys.argv[2])
mod = importlib.import_module("repro_torch.examples." + name)
for k in ops.LAUNCHES:
    ops.LAUNCHES[k] = 0
t0 = time.perf_counter()
mod.main(argv)
if torch.cuda.is_available():
    torch.cuda.synchronize()
print(json.dumps({"example": name, "argv": argv,
                  "main_s": time.perf_counter() - t0,
                  "launches": dict(ops.LAUNCHES)}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of the examples")
    ap.add_argument("--out", default=os.path.join("build",
                                                  "examples_card"))
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    except FileNotFoundError:
        smi = "nvidia-smi: not found"
    print(smi, flush=True)
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    summary, failed = [], []
    for name, ex_argv in RUNS:
        if only is not None and name not in only:
            continue
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", _CHILD, name, json.dumps(ex_argv)],
            capture_output=True, text=True, env=env, cwd=ROOT)
        wall = time.perf_counter() - t0
        with open(os.path.join(args.out, name + ".log"), "w") as f:
            f.write(out.stdout + out.stderr)
        lines = out.stdout.strip().splitlines()
        if out.returncode != 0 or not lines:
            failed.append(name)
            print(f"{name}: FAILED (exit {out.returncode})\n"
                  f"{out.stderr[-2000:]}", flush=True)
            continue
        row = json.loads(lines[-1])
        row["wall_s"] = wall
        summary.append(row)
        print("\n".join(lines[:-1]), flush=True)
        print(json.dumps(row), flush=True)
    print(json.dumps({"examples": summary, "failed": failed,
                      "card": smi}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

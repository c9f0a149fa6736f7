#!/usr/bin/env python3
"""Ablation of the lru_scan kernel's tma route on one NVIDIA GPU.

    python3 lru_scan_ablation.py [--variants as_built,stages_8,...]
                                 [--sass PATH]

Each variant is a copy of ``csrc/lru_scan.cu`` with one constant or one
line changed (``VARIANTS``: the ring's stages, the tile's time steps,
the slab's warps, the tensor maps' L2 promotion; ``store_off`` writes no
h in full tiles, to show what the stores cost: its output is wrong and
only its times are read). A variant names the exact text it replaces,
so an edit of those lines in ``lru_scan.cu`` must be carried over here:
a variant whose text is not in the source stops the run. All copies are built together with the
kernel's own nvcc flags into ``build/lru_ablation/``; then each is
loaded in turn in this process, checked bit for bit against the plain
version at a ragged training-width shape, and timed (chip_smoke's
median of queued CUDA-event windows) at the f32 forward and reverse of
the training shape (1, 4096, 4096) and the f32 and bf16 forwards of the
prefill shape (4, 4096, 4096). Last, as a yardstick for the bytes
alone, ``torch.add(a, b, out=h)`` at the training and prefill shapes in
f32 (the same bytes read and written, no chain). ``--variants`` gives
the order of the runs; a name may come more than once (as_built first
and last, to see drift). Prints one JSON line per variant and one for
the yardstick, then the card's name and power limit. ``--sass PATH``
also writes the SASS of the first variant's library to PATH. Imports
no JAX.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

# name -> [(text in csrc/lru_scan.cu, its replacement)]
VARIANTS = {
    "as_built": [],
    "stages_2": [("kMaxStages = 4;", "kMaxStages = 2;")],
    "stages_8": [("kMaxStages = 4;", "kMaxStages = 8;")],
    "tc_32": [("kTc = 64;", "kTc = 32;")],
    "tc_128": [("kTc = 64;", "kTc = 128;")],
    "slab_32": [("kNW = 4;", "kNW = 1;")],
    "slab_64": [("kNW = 4;", "kNW = 2;")],
    "l2_none": [("L2_PROMOTION_L2_256B", "L2_PROMOTION_NONE")],
    "l2_128": [("L2_PROMOTION_L2_256B", "L2_PROMOTION_L2_128B")],
    "store_off": [("        *p = from_f32<T>(h);\n", "")],
}
# (name, (B, L, R, h0), dtype, reverse)
TIMINGS = [("fwd_train", (1, 4096, 4096, False), "float32", False),
           ("rev_train", (1, 4096, 4096, False), "float32", True),
           ("fwd_prefill", (4, 4096, 4096, False), "float32", False),
           ("fwd_prefill_bf16", (4, 4096, 4096, False), "bfloat16", False)]
CHECK_SHAPE = (1, 4099, 4096, True)


def build_variants(names):
    """Patched copies of the source, one nvcc each, started together."""
    from repro_torch.kernels import build
    src = (build.CSRC / "lru_scan.cu").read_text()
    out_dir = build.BUILD_DIR.parent / "lru_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in dict.fromkeys(names):     # a name may repeat in the order
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.flags("lru_scan"), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = so
    return libs


def run_variant(torch, cs, ls, path):
    ls.build._LIBS["lru_scan"] = ctypes.CDLL(str(path))
    out = {}
    a, b, h0 = cs.lru_inputs(torch, CHECK_SHAPE, torch.float32, 7)
    out["bit_equal"] = bool(torch.equal(ls.lru_scan_cuda(a, b, h0),
                                        ls.lru_scan_torch(a, b, h0)))
    lam = ls.lru_scan_reverse_cuda(a, b)
    ins = [x.clone().requires_grad_(True) for x in (a, b)]
    want = torch.autograd.grad(ls.lru_scan_torch(*ins), ins[1], b)[0]
    out["reverse_bit_equal"] = bool(torch.equal(lam, want))
    for name, shape, dname, reverse in TIMINGS:
        a, b, h0 = cs.lru_inputs(torch, shape, getattr(torch, dname), 100)
        if reverse:
            out[name] = cs.time_ms(torch,
                                   lambda: ls.lru_scan_reverse_cuda(a, b))
        else:
            out[name] = cs.time_ms(torch, lambda: ls.lru_scan_cuda(a, b, h0))
        del a, b, h0
    return out


def same_bytes_add(torch, cs):
    """A yardstick for the bytes alone: ``torch.add(a, b, out=h)`` reads
    a and b and writes h once, as the scan does, with no chain."""
    out = {}
    for name, shape, dname, _ in TIMINGS[::2]:
        a, b, _ = cs.lru_inputs(torch, shape, getattr(torch, dname), 100)
        h = torch.empty_like(a)
        out[name] = cs.time_ms(torch, lambda: torch.add(a, b, out=h))
        del a, b, h
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--sass", metavar="PATH")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    if not torch.cuda.is_available():
        print("lru_scan_ablation needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import lru_scan as ls
    libs = build_variants(names)
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(ls.build.nvcc()),
                                 "cuobjdump")
        with open(args.sass, "w") as f:
            subprocess.run([cuobjdump, "-sass", str(libs[names[0]])],
                           stdout=f, stderr=subprocess.STDOUT, check=False)
    for name in names:
        res = run_variant(torch, cs, ls, libs[name])
        print(json.dumps({"variant": name, **res}), flush=True)
    print(json.dumps({"same_bytes_add": same_bytes_add(torch, cs)}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving launcher: prefill a batch of prompts, then decode greedily.

    python -m repro_torch.launch.serve --arch stablelm-12b \\
        [--smoke] [--batch 2] [--prompt-len 32] [--decode-steps 16] \\
        [--seed 0] [--device cuda]

Runs on the current CUDA device unless ``--device`` names another (pass
``--device cpu`` to run the plain PyTorch path on the CPU). Counterpart
of ``repro.launch.serve``.
"""
from __future__ import annotations

import argparse
import time
from typing import List, NamedTuple

import torch

from repro_torch import device as _device
from repro_torch import models
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import make_batch


class ServeResult(NamedTuple):
    prefill_logits: torch.Tensor       # (B, 1, V): the last prompt token's
    step_logits: List[torch.Tensor]    # decode_steps x (B, 1, V)
    tokens: torch.Tensor               # (B, 1 + decode_steps) int32
    prefill_s: float
    decode_s: float
    cache: dict


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


def serve(cfg, params, prompt: torch.Tensor,
          decode_steps: int) -> ServeResult:
    """Prefill ``prompt`` (B, S) with room for ``decode_steps`` more
    tokens, then decode greedily; wall times end in a synchronize."""
    dev = prompt.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = models.prefill(cfg, params, {"tokens": prompt},
                                   pad_to=prompt.shape[1] + decode_steps)
    tok = _greedy(logits)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out_tokens, step_logits = [tok], []
    t0 = time.perf_counter()
    for _ in range(decode_steps):
        step, cache = models.serve_step(cfg, params, cache, tok)
        tok = _greedy(step)
        step_logits.append(step)
        out_tokens.append(tok)
    _sync(dev)
    return ServeResult(logits, step_logits, torch.cat(out_tokens, dim=1),
                       prefill_s, time.perf_counter() - t0, cache)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = models.init(cfg, args.seed, device=dev)
    batch = make_batch(cfg, args.batch, args.prompt_len, args.seed, 0,
                       device=dev)
    res = serve(cfg, params, batch["tokens"], args.decode_steps)
    print(f"prefill({args.prompt_len} tokens x{args.batch}) "
          f"{res.prefill_s:.2f}s on {dev}")
    print(f"decoded {args.decode_steps} steps in {res.decode_s:.2f}s "
          f"({res.decode_s / max(args.decode_steps, 1) * 1e3:.1f} ms/token)")
    print("sample token ids:", res.tokens[0].tolist())
    return res


if __name__ == "__main__":
    main()

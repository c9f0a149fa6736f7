"""AdamW on trees of tensors, with a configurable moment type
(counterpart of ``repro.optim.adamw``).

Plain functions with the JAX package's update rule and order of
operations: a global-norm clip, bias correction, the decoupled decay
inside ``delta``, all update math in float32, m and v stored in
``moment_dtype``, and the parameters cast back to their own type.
``torch.optim.AdamW`` is not used: its order of operations and its
moment types differ. ``step`` is a 0-d int32 tensor, as in JAX, so a
train state's bytes count the same in both packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch import tree as _tree
from repro_torch.models.common import torch_dtype

Params = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"


def adamw_init(params: Params, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.moment_dtype`` with ``params``' structure (a
    module's moments keyed by its parameters' names) and step 0."""
    dt = torch_dtype(cfg.moment_dtype)
    flat = list(_tree.flatten(params))

    def zeros():
        return _tree.unflatten({
            path: torch.zeros(p.shape, dtype=dt, device=p.device)
            for path, p in flat})

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=flat[0][1].device)}


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine to 0 at
    ``cfg.total_steps``; float32 like the JAX schedule."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = (step / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in _tree.leaves(tree)))


@torch.no_grad()
def adamw_update(grads: Params, opt_state: dict, params: Params,
                 cfg: AdamWConfig) -> Tuple[dict, dict]:
    """One AdamW step. Returns (new params, new optimizer state) as new
    trees with ``params``' structure (a module's as the dict of its
    parameters' names); the inputs are left as they were."""
    step = opt_state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = (cfg.grad_clip / gnorm.clamp(min=1e-12)).clamp(max=1.0) \
        if cfg.grad_clip > 0 else 1.0

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    mdt = torch_dtype(cfg.moment_dtype)
    grads, m, v = (dict(_tree.flatten(t)) for t in
                   (grads, opt_state["m"], opt_state["v"]))
    new_p, new_m, new_v = {}, {}, {}
    for path, p in _tree.flatten(params):
        g = grads[path].float() * scale
        mf = m[path].float() * b1 + g * (1 - b1)
        vf = v[path].float() * b2 + torch.square(g) * (1 - b2)
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay > 0:
            delta = delta + cfg.weight_decay * p.float()
        new_p[path] = (p.float() - lr * delta).to(p.dtype)
        new_m[path], new_v[path] = mf.to(mdt), vf.to(mdt)
    return _tree.unflatten(new_p), {"m": _tree.unflatten(new_m),
                                    "v": _tree.unflatten(new_v),
                                    "step": step}

"""Train-step factory: autograd + AdamW + gradient accumulation
(counterpart of ``repro.trainer``).

Microbatching (``microbatches > 1``) splits the global batch along its
batch axis and accumulates the microbatches' gradients in float32, so
the activations held for one backward shrink by the microbatch factor.

A train state is ``{"params": model, "opt": {"m", "v", "step"}}``: the
model module (its parameters require grad), and the AdamW moments keyed
by the parameters' names. The step updates the module's parameters in
place and returns the state with the new moments. ``abstract_train_state``
(the dry-run's shapes) is not ported: it comes with the dry-run slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, seed: int = 0,
                     *, device=None) -> dict:
    """Random parameters from ``seed`` (``models.init``) with gradients
    on, and zero moments, on ``device`` (default: the current CUDA
    device; raises without one)."""
    model = models.init(cfg, seed, device=device).requires_grad_(True)
    return {"params": model, "opt": adamw_init(model, opt_cfg)}


def _split_micro(batch: dict, m: int) -> dict:
    def sp(x):
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} does not split into {m} "
                             f"microbatches")
        return x.reshape((m, b // m) + tuple(x.shape[1:]))
    return {k: sp(x) for k, x in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1) -> Callable:
    """-> train_step(state, batch) -> (state, metrics), metrics
    ``{"loss": float32 0-d, "step": int32 0-d}``."""

    def train_step(state: dict, batch: dict):
        model = state["params"]
        names, params = zip(*model.named_parameters())
        if microbatches == 1:
            loss = models.loss_fn(cfg, model, batch)
            grads = torch.autograd.grad(loss, params)
            loss = loss.detach()
        else:
            micro = _split_micro(batch, microbatches)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in params]
            loss = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
            for i in range(microbatches):
                mb = {k: x[i] for k, x in micro.items()}
                lm = models.loss_fn(cfg, model, mb)
                gm = torch.autograd.grad(lm, params)
                grads = [a + g.float() / microbatches
                         for a, g in zip(grads, gm)]
                loss = loss + lm.detach() / microbatches
        new_params, new_opt = adamw_update(
            dict(zip(names, grads)), state["opt"], dict(zip(names, params)),
            opt_cfg)
        with torch.no_grad():
            for name, p in zip(names, params):
                p.copy_(new_params[name])
        metrics = {"loss": loss.float(), "step": new_opt["step"]}
        return {"params": model, "opt": new_opt}, metrics

    return train_step

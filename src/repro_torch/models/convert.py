"""Carry the JAX package's parameters into the port.

:func:`params_from_numpy` takes the JAX package's parameter tree of a
model (``repro.models.init``'s nested dict, leaves as numpy arrays, the
per-layer leaves stacked on a leading layer axis: ``layers`` for the
dense and ssm families, ``rec`` and ``attn`` for the hybrid) and
returns the port's module holding the same values, each stacked leaf
split into its layers. :func:`train_state_from_numpy` does the same
for a whole train state, the AdamW moments and step included.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, dense, hybrid, ssm

_MODELS = {"dense": (dense.DenseLM, dense.param_defs),
           "ssm": (ssm.MambaLM, ssm.param_defs),
           "hybrid": (hybrid.HybridLM, hybrid.param_defs)}


def to_tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same type. A bfloat16 array
    (ml_dtypes' numpy type, which ``torch.from_numpy`` rejects) goes
    through its 16-bit pattern. A tensor (``checkpoint.load_tree``'s
    leaves) passes through."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:          # torch warns on read-only memory
        a = a.copy()
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _keys(tree: dict) -> dict:
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in tree.items()}


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: dict, device):
    """The port's module for ``cfg`` on ``device`` with the values of
    ``tree``; raises on a missing, extra or misshapen leaf, and on a leaf
    whose type is not the one its definition gives (the model's type,
    or the leaf's own, as float32 ``lam`` in a bfloat16 hybrid)."""
    if cfg.family not in _MODELS:
        raise NotImplementedError(
            f"params_from_numpy converts the dense, ssm and hybrid "
            f"families; got {cfg.family!r}")
    cls, param_defs = _MODELS[cfg.family]
    model = cls(cfg, device=_device.resolve(device))
    defs = param_defs(cfg)
    if _keys(tree) != _keys(defs):
        raise ValueError(f"parameter tree keys {_keys(tree)} do not match "
                         f"the {cfg.name} definition {_keys(defs)}")

    def put(dst: torch.Tensor, src: torch.Tensor, name: str):
        if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
            raise ValueError(f"{name}: expected {dst.dtype} "
                             f"{tuple(dst.shape)}, got {src.dtype} "
                             f"{tuple(src.shape)}")
        dst.copy_(src)

    for name, a in tree.items():
        if isinstance(a, dict):
            for lname, la in a.items():
                t = to_tensor(la)
                n = defs[name][lname].shape[0]
                if t.dim() == 0 or t.shape[0] != n:
                    raise ValueError(f"{name}.{lname}: expected {n} stacked "
                                     f"layers, got shape {tuple(t.shape)}")
                for li in range(n):
                    put(model.leaf(lname, li, name), t[li],
                        f"{name}.{lname}[{li}]")
        else:
            put(model.leaf(name), to_tensor(a), name)
    return model


@torch.no_grad()
def train_state_from_numpy(cfg: ModelConfig, tree: dict, device) -> dict:
    """The port's train state (``trainer.init_train_state``'s layout) on
    ``device`` from the JAX package's: ``{"params", "opt": {"m", "v",
    "step"}}`` with numpy leaves (or tensors), m and v shaped like the
    parameters and split into layers the same way. The moments keep
    their own type (``moment_dtype``); the parameters require grad."""
    model = params_from_numpy(cfg, tree["params"], device)
    model.requires_grad_(True)
    names = {v: k for k, v in common.DTYPES.items()}

    def moments(mt: dict) -> dict:
        # a module of the moments' type holds them, split and checked as
        # the parameters are, under the parameters' names
        first = next(iter(mt.values()))
        first = next(iter(first.values())) if isinstance(first, dict) \
            else first
        dtype = names[to_tensor(first).dtype]
        held = params_from_numpy(cfg.replace(dtype=dtype), mt, device)
        return {n: p.detach() for n, p in held.named_parameters()}

    opt = tree["opt"]
    step = to_tensor(np.asarray(opt["step"])).to(torch.int32)
    return {"params": model,
            "opt": {"m": moments(opt["m"]), "v": moments(opt["v"]),
                    "step": step.to(next(model.parameters()).device)}}

"""Carry the JAX package's parameters into the port.

:func:`params_from_numpy` takes the JAX package's parameter tree of a
model (``repro.models.init``'s nested dict, leaves as numpy arrays, the
per-layer leaves stacked on a leading layer axis: ``layers`` for the
dense, moe, ssm and vlm families, ``rec`` and ``attn`` for the hybrid,
``enc`` and ``dec`` for whisper; vlm's ``projector`` is a dict of
unstacked leaves) and
returns the port's module holding the same values, each stacked leaf
split into its layers. :func:`train_state_from_numpy` does the same
for a whole train state, the AdamW moments and step included.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense, hybrid, moe, ssm, vlm, whisper

_MODELS = {"dense": (dense.DenseLM, dense.param_defs),
           "moe": (moe.MoELM, moe.param_defs),
           "ssm": (ssm.MambaLM, ssm.param_defs),
           "hybrid": (hybrid.HybridLM, hybrid.param_defs),
           "audio": (whisper.WhisperLM, whisper.param_defs),
           "vlm": (vlm.VisionLM, vlm.param_defs)}


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


def _check_keys(cfg: ModelConfig, tree: dict, defs: dict, what: str):
    if _keys(tree) != _keys(defs):
        raise ValueError(f"{what} tree keys {_keys(tree)} do not match "
                         f"the {cfg.name} definition {_keys(defs)}")


def _leaf_pairs(model, tree: dict, defs: dict):
    """(parameter, tensor, name) for every leaf of ``tree``, a stacked
    leaf (its definition's first logical axis ``"layers"``) split into
    its layers (``model.leaf`` names the parameter); raises on a stack
    of the wrong depth."""
    for name, a in tree.items():
        if not isinstance(a, dict):
            yield model.leaf(name), to_tensor(a), name
            continue
        for lname, la in a.items():
            t = to_tensor(la)
            if not dense.is_stacked(defs[name][lname]):
                yield model.leaf(lname, None, name), t, f"{name}.{lname}"
                continue
            n = defs[name][lname].shape[0]
            if t.dim() == 0 or t.shape[0] != n:
                raise ValueError(f"{name}.{lname}: expected {n} stacked "
                                 f"layers, got shape {tuple(t.shape)}")
            for li in range(n):
                yield model.leaf(lname, li, name), t[li], \
                    f"{name}.{lname}[{li}]"


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: dict, device):
    """The port's module for ``cfg`` on ``device`` with the values of
    ``tree``; raises on a missing, extra or misshapen leaf, and on a leaf
    whose type is not the one its definition gives (the model's type,
    or the leaf's own, as float32 ``lam`` in a bfloat16 hybrid)."""
    if cfg.family not in _MODELS:
        raise KeyError(f"unknown model family {cfg.family!r}")
    cls, param_defs = _MODELS[cfg.family]
    model = cls(cfg, device=_device.resolve(device))
    defs = param_defs(cfg)
    _check_keys(cfg, tree, defs, "parameter")
    for dst, src, name in _leaf_pairs(model, tree, defs):
        if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
            raise ValueError(f"{name}: expected {dst.dtype} "
                             f"{tuple(dst.shape)}, got {src.dtype} "
                             f"{tuple(src.shape)}")
        dst.copy_(src)
    return model


@torch.no_grad()
def train_state_from_numpy(cfg: ModelConfig, tree: dict, device) -> dict:
    """The port's train state (``trainer.init_train_state``'s layout) on
    ``device`` from the JAX package's: ``{"params", "opt": {"m", "v",
    "step"}}`` with numpy leaves (or tensors), m and v shaped like the
    parameters and split into layers the same way (``layers``, or the
    hybrid's ``rec`` and ``attn`` stacks). Every moment has the one
    type ``moment_dtype`` gave it, whatever its parameter's type (the
    hybrid's float32 ``lam`` has bfloat16 moments when the others do,
    as in JAX); the parameters require grad."""
    model = params_from_numpy(cfg, tree["params"], device)
    model.requires_grad_(True)
    names = {id(p): n for n, p in model.named_parameters()}
    defs = _MODELS[cfg.family][1](cfg)

    def moments(mt: dict) -> dict:
        # keyed by the parameters' names, each checked against its
        # parameter's shape; one type for all
        _check_keys(cfg, mt, defs, "moment")
        out = {}
        for p, src, name in _leaf_pairs(model, mt, defs):
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"moment {name}: expected "
                                 f"{tuple(p.shape)}, got {tuple(src.shape)}")
            out[names[id(p)]] = src.to(p.device).clone()
        dtypes = {t.dtype for t in out.values()}
        if len(dtypes) != 1:
            raise ValueError(f"moments of more than one type: {dtypes}")
        return {n: out[n] for n in names.values()}

    opt = tree["opt"]
    step = to_tensor(np.asarray(opt["step"])).to(torch.int32)
    return {"params": model,
            "opt": {"m": moments(opt["m"]), "v": moments(opt["v"]),
                    "step": step.to(next(model.parameters()).device)}}

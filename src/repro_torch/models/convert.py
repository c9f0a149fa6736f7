"""Carry the JAX package's parameters into the port.

:func:`params_from_numpy` takes the JAX package's parameter tree of a
dense model (``repro.models.dense.init``'s nested dict, leaves as numpy
arrays, the per-layer leaves stacked on a leading layer axis) and
returns the port's :class:`~repro_torch.models.dense.DenseLM` holding
the same values, each stacked leaf split into its layers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same type. A bfloat16 array
    (ml_dtypes' numpy type, which ``torch.from_numpy`` rejects) goes
    through its 16-bit pattern."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:          # torch warns on read-only memory
        a = a.copy()
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: dict, device) -> dense.DenseLM:
    """The port's module for ``cfg`` on ``device`` with the values of
    ``tree``; raises on a missing, extra or misshapen leaf, and on a leaf
    whose type is not the model's."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"params_from_numpy converts dense models; got {cfg.family!r}")
    model = dense.DenseLM(cfg, device=_device.resolve(device))
    defs = dense.param_defs(cfg)
    if set(tree) != set(defs) or set(tree["layers"]) != set(defs["layers"]):
        raise ValueError(f"parameter tree keys {sorted(tree)} / "
                         f"{sorted(tree.get('layers', {}))} do not match "
                         f"the {cfg.name} definition")

    def put(dst: torch.Tensor, src: torch.Tensor, name: str):
        if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
            raise ValueError(f"{name}: expected {dst.dtype} "
                             f"{tuple(dst.shape)}, got {src.dtype} "
                             f"{tuple(src.shape)}")
        dst.copy_(src)

    for name, a in tree.items():
        if name == "layers":
            for lname, la in a.items():
                t = to_tensor(la)
                for li in range(cfg.n_layers):
                    put(model.leaf(lname, li), t[li], f"layers.{lname}[{li}]")
        else:
            put(model.leaf(name), to_tensor(a), name)
    return model

"""Checkpointing: tree save/restore + grace-period estimation
(counterpart of ``repro.checkpoint.ckpt``).

The substrate behind checkpoint-based preemption (the paper's grace
period, §2): suspending a training job flushes its train state to
storage, and the grace period it asks for is ``state_bytes / storage
bandwidth`` with serialization slack.

The file is the JAX package's ``.npz`` layout: one array per leaf, named
by its ``§``-joined key path, bfloat16 stored as its uint16 pattern and
named in the ``__meta__`` entry. The port's key paths are its own (a
module's leaves by their dotted parameter names); :func:`load_tree`
reads any such file, the JAX package's included, into nested dicts.
"""
from __future__ import annotations

import json
import math
import os
import zipfile
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import tree as _tree

Tree = Any
_SEP = "§"
_META = "__meta__"


def _flat(tree: Tree) -> Dict[str, torch.Tensor]:
    return {_SEP.join(path): leaf for path, leaf in _tree.flatten(tree)}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _from_numpy(a: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_pytree(tree: Tree, path: str) -> int:
    """Write a tree to ``path`` (.npz, as ``np.savez`` writes it). Leaves
    go to the host one at a time, so the host holds one leaf's bytes,
    not the state's. Returns the bytes written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = _flat(tree)
    meta = {k: "bfloat16" for k, t in arrays.items()
            if t.dtype == torch.bfloat16}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        items = [(_META, np.asarray(json.dumps(meta)))]
        items += [(k, t) for k, t in arrays.items()]
        for k, t in items:
            a = t if isinstance(t, np.ndarray) else _to_numpy(t)
            with zf.open(k + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, a, allow_pickle=False)
    return os.path.getsize(path)


def load_tree(path: str) -> dict:
    """Every leaf of a checkpoint as a CPU tensor (bfloat16 restored), in
    nested dicts split at ``§``: the JAX package's files included, whose
    trees ``models.convert.train_state_from_numpy`` carries over."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data[_META]))
        return _tree.unflatten({
            tuple(k.split(_SEP)): _from_numpy(data[k], meta.get(k) ==
                                              "bfloat16")
            for k in data.files if k != _META})


@torch.no_grad()
def load_pytree(template: Tree, path: str) -> Tree:
    """Restore a tree saved by :func:`save_pytree` into ``template`` in
    place, leaf by leaf (each keeps its type and device), and return it.
    Raises on a missing leaf, and on a leaf whose shape or type is not
    the template's. (The JAX version returns a new tree.)"""
    flat = _flat(template)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data[_META]))
        missing = sorted(set(flat) - set(data.files))
        if missing:
            raise KeyError(f"checkpoint missing keys: {missing[:5]} ...")
        for k, t in flat.items():
            src = _from_numpy(data[k], meta.get(k) == "bfloat16")
            if src.shape != t.shape or src.dtype != t.dtype:
                raise ValueError(f"{k}: checkpoint holds {src.dtype} "
                                 f"{tuple(src.shape)}, the template "
                                 f"{t.dtype} {tuple(t.shape)}")
            t.copy_(src)
    return template


def state_bytes(tree: Tree) -> int:
    return int(sum(t.numel() * t.element_size()
                   for t in _tree.leaves(tree)))


def estimate_grace_period(tree: Tree, storage_bw_bytes_per_s: float = 2e9,
                          slack: float = 1.5) -> int:
    """Suggested grace period [minutes] for a job with this train state:
    slack * bytes / bandwidth, at least one scheduler tick when nonzero."""
    b = state_bytes(tree)
    seconds = slack * b / storage_bw_bytes_per_s
    return max(math.ceil(seconds / 60.0), 1) if b else 0

"""Parallelism plans: logical param/cache axes -> mesh partition specs
(counterpart of ``repro.sharding.plans``).

The same rules table per (arch × input-shape kind) as the JAX package,
shape-aware and divisibility-safe: a logical axis is sharded over a
mesh axis only when the dimension divides the axis size and the mesh
axis is not already used by another dim of the same tensor; otherwise
it stays replicated (e.g. kv=8 heads on a model=16 axis: the KV
projections replicate, as Megatron TP does with kv < tp).

Plans:
  * train: batch over (pod, data); TP over model on heads/mlp/vocab/
    experts; FSDP (embed/weights over data axes too) + bf16 adam moments
    + microbatching for the >=100B archs; pure FSDP (ZeRO-3, batch over
    every axis) or Megatron sequence parallelism for the archs of
    ``_TRAIN_STRATEGY``.
  * prefill: like train, no microbatching.
  * decode: weights TP over model + FSDP over (pod, data) when batch
    can't use them; KV cache batch over data, cache seq over model.

PyTorch lowers nothing onto these meshes (``launch/mesh.py``): a leaf's
sharding here is a :class:`Sharding`, its spec (one entry per
dimension: a mesh axis name, a tuple of names, or None, as in JAX's
``PartitionSpec``) and the shape of one device's shard, from which the
dry-run counts bytes per device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch import models
from repro_torch import tree as _tree
from repro_torch.configs.base import InputShape, ModelConfig

Axes = Tuple[str, ...]


@dataclass(frozen=True)
class Plan:
    """Resolved plan for one (arch × shape × mesh)."""
    rules: Dict[str, Axes]          # logical axis -> mesh axes
    batch_axes: Axes                # data-parallel axes for the batch dim
    microbatches: int = 1
    opt_dtype: str = "float32"
    remat: str = "full"
    strategy: str = "tp"            # tp | tp_sp | fsdp (see arch_plan)
    notes: str = ""


# archs that need FSDP-weight sharding + bf16 moments + grad accumulation
# to fit a pod: name -> (microbatches, moment dtype, remat)
_BIG = {"nemotron-4-340b": (16, "bfloat16", "full"),
        "mistral-large-123b": (4, "float32", "full"),
        "mixtral-8x22b": (4, "float32", "full"),
        "command-r-35b": (2, "float32", "full")}

# train-shape strategy override (the JAX package's, set by its TPU
# measurements): pure FSDP (ZeRO-3: batch over BOTH mesh axes, weights
# fully sharded, no tensor parallelism) or Megatron sequence parallelism
_TRAIN_STRATEGY = {"recurrentgemma-9b": "fsdp",
                   "stablelm-12b": "fsdp",
                   "internvl2-2b": "fsdp",
                   "nemotron-4-340b": "tp_sp",
                   "mistral-large-123b": "tp_sp"}


def arch_plan(cfg: ModelConfig, shape: InputShape, mesh) -> Plan:
    axes = mesh.axis_names
    dp: Axes = tuple(a for a in ("pod", "data") if a in axes)
    tp = "model" if "model" in axes else None

    micro, opt_dtype, remat = _BIG.get(cfg.name, (1, "float32", cfg.remat))
    fsdp = cfg.name in _BIG

    rules: Dict[str, Axes] = {
        "heads": (tp,), "kv": (tp,), "mlp": (tp,), "vocab": (tp,),
        "experts": (tp,), "head_dim": (), "state": (), "layers": (),
        "embed": dp if fsdp else (),
        # cache axes
        "cache_batch": dp, "cache_seq": (tp,),
    }
    if shape.kind == "train":
        strategy = _TRAIN_STRATEGY.get(cfg.name, "tp")
        if strategy == "tp_sp":
            if shape.global_batch % _prod(mesh, dp) != 0:
                dp = dp[-1:]
            return Plan(rules=rules, batch_axes=dp, microbatches=micro,
                        opt_dtype=opt_dtype, remat=remat,
                        strategy="tp_sp", notes="megatron-sp")
        if strategy == "fsdp" and tp and \
                shape.global_batch % _prod(mesh, dp + (tp,)) == 0:
            # ZeRO-3: batch and weights sharded over ALL mesh axes; no TP.
            # Only when the batch spans the whole mesh; otherwise (e.g.
            # batch 256 on the 512-device two-pod mesh) fall through to tp.
            all_axes = dp + (tp,)
            rules = dict(rules)
            rules.update({"embed": all_axes[:-1] or dp})
            return Plan(rules=rules, batch_axes=all_axes,
                        microbatches=micro, opt_dtype=opt_dtype,
                        remat=remat, strategy="fsdp", notes="zero3")
        if shape.global_batch % _prod(mesh, dp) != 0:
            dp = dp[-1:]                      # fall back to data only
        return Plan(rules=rules, batch_axes=dp, microbatches=micro,
                    opt_dtype=opt_dtype, remat=remat,
                    notes="fsdp" if fsdp else "tp+dp")
    if shape.kind == "prefill":
        return Plan(rules=rules, batch_axes=dp, microbatches=1,
                    opt_dtype=opt_dtype, remat=cfg.remat)
    # decode: batch may be tiny; weights lean on FSDP over unused dp axes.
    # When the batch DOES occupy the data axis, weights are model-sharded
    # only (a data-axis weight shard would be re-gathered every step).
    dp_batch = tuple(a for a in dp
                     if shape.global_batch % _prod(mesh, (a,)) == 0)
    rules = dict(rules)
    rules["embed"] = dp if shape.global_batch < _prod(mesh, dp) else ()
    rules["cache_batch"] = dp_batch
    return Plan(rules=rules, batch_axes=dp_batch, microbatches=1,
                opt_dtype=opt_dtype, remat="none")


def _prod(mesh, axes: Axes) -> int:
    n = 1
    for a in axes:
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def device_rows(batch: int, plan: Plan, mesh) -> int:
    """One device's rows of a ``batch``-row leaf (:func:`batch_sharding`'s
    rule: split over the plan's batch axes when they divide it)."""
    n = _prod(mesh, plan.batch_axes)
    return batch // n if plan.batch_axes and batch % n == 0 else batch


def tp_size(plan: Plan, mesh) -> int:
    """The model axis's size where the plan uses it for tensor
    parallelism (not as a batch axis), else 1."""
    if "model" in mesh.axis_names and "model" not in plan.batch_axes:
        return mesh.shape["model"]
    return 1


def gather_axes(plan: Plan, mesh) -> frozenset:
    """The axes over which a weight split is FSDP (ZeRO-3): gathered
    before each use and its gradient reduce-scattered: the plan's batch
    axes and the data axes present."""
    return frozenset(plan.batch_axes) | {
        a for a in ("pod", "data") if a in mesh.axis_names}


def spec_from_logical(logical: Tuple[Optional[str], ...],
                      shape: Tuple[int, ...], plan: Plan, mesh) -> tuple:
    """One tensor's logical axes as a partition spec, one entry per
    dimension, enforcing divisibility and no mesh-axis reuse: JAX's
    ``PartitionSpec`` with its trailing replicated dims kept."""
    used = set()
    parts = []
    for dim, name in zip(shape, logical):
        assigned = None
        if name is not None:
            want = plan.rules.get(name, ())
            cand = tuple(a for a in want
                         if a and a in mesh.axis_names and a not in used)
            if cand:
                n = _prod(mesh, cand)
                if dim % n == 0:
                    assigned = cand if len(cand) > 1 else cand[0]
                    used.update(cand)
                elif len(cand) == 1 and dim % mesh.shape[cand[0]] == 0:
                    assigned = cand[0]
                    used.add(cand[0])
        parts.append(assigned)
    return tuple(parts)


def entry_axes(entry) -> Axes:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class Sharding:
    """One leaf's layout: ``spec`` has one entry per dimension (a mesh
    axis name, a tuple of names, or None); ``shard_shape`` is one
    device's piece."""
    spec: tuple
    shard_shape: Tuple[int, ...]

    @property
    def axes(self) -> Axes:
        """Every mesh axis the leaf is split over."""
        return tuple(a for e in self.spec for a in entry_axes(e))


def make_sharding(spec: tuple, shape: Tuple[int, ...], mesh) -> Sharding:
    """The :class:`Sharding` of a tensor of ``shape`` under ``spec`` (one
    entry per dimension)."""
    assert len(spec) == len(shape), (spec, shape)
    shard = tuple(d // _prod(mesh, entry_axes(e))
                  for d, e in zip(shape, spec))
    return Sharding(tuple(spec), shard)


def _tree_sharding(specs_tree, shapes_tree, plan: Plan, mesh):
    specs = dict(_tree.flatten(specs_tree))
    return _tree.unflatten({
        path: make_sharding(spec_from_logical(specs[path], t.shape, plan,
                                              mesh), tuple(t.shape), mesh)
        for path, t in _tree.flatten(shapes_tree)})


def param_sharding(cfg: ModelConfig, plan: Plan, mesh):
    """Sharding tree matching ``models.abstract_params(cfg)``."""
    return _tree_sharding(models.param_logical_specs(cfg),
                          models.abstract_params(cfg), plan, mesh)


def train_state_sharding(cfg: ModelConfig, plan: Plan, mesh):
    """Sharding tree of ``trainer.abstract_train_state``: the moments
    shard like their parameters, the step replicates."""
    ps = param_sharding(cfg, plan, mesh)
    return {"params": ps,
            "opt": {"m": ps, "v": ps, "step": make_sharding((), (), mesh)}}


def batch_sharding(batch_abstract: dict, plan: Plan, mesh):
    """Shard every batch leaf on its leading (batch) dim."""
    ba = tuple(a for a in plan.batch_axes if a in mesh.axis_names)

    def leaf(x):
        spec = [None] * x.dim()
        if ba and x.shape and x.shape[0] % _prod(mesh, ba) == 0:
            spec[0] = ba if len(ba) > 1 else ba[0]
        return make_sharding(tuple(spec), tuple(x.shape), mesh)

    return {k: leaf(x) for k, x in batch_abstract.items()}


def cache_sharding(cfg: ModelConfig, plan: Plan, mesh, cache_abstract):
    return _tree_sharding(models.cache_logical_specs(cfg), cache_abstract,
                          plan, mesh)


def shard_bytes(tree, shardings) -> int:
    """Bytes one device holds of ``tree`` (meta tensors) laid out by
    ``shardings`` (the matching tree of :class:`Sharding`)."""
    sh = dict(_tree.flatten(shardings))
    total = 0
    for path, t in _tree.flatten(tree):
        n = 1
        for d in sh[path].shard_shape:
            n *= d
        total += n * t.element_size()
    return total

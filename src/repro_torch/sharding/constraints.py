"""Activation layouts under a strategy and a mesh (counterpart of
``repro.sharding.constraints``).

The JAX models pin their activations' layouts at block boundaries with
``constrain(x, *spec)`` (a ``with_sharding_constraint`` that is a no-op
where an axis is absent or a dim does not divide). The port's models
run on one card and call nothing of the kind; the dry-run resolves the
same specs here to count the collectives a layout implies
(``launch/roofline.py::plan_collectives``). :func:`constrain` takes a
shape and returns the spec JAX would pin, or None where JAX leaves the
tensor unconstrained.
"""
from __future__ import annotations

from typing import Optional, Tuple

BATCH = "__batch__"      # placeholder: ("pod","data") axes when present
SEQ = "__seq__"          # sequence dim: sharded over "model" under tp_sp


def constrain(shape: Tuple[int, ...], *spec, mesh,
              strategy: str) -> Optional[tuple]:
    """The partition spec (one entry per dim of ``shape``) that the JAX
    ``constrain(x, *spec)`` pins under ``strategy`` on ``mesh``, or None
    where it returns x unconstrained (no mesh, or every dim replicated).

    strategy: "tp" (hidden dims pin to the model axis); "tp_sp" (tp +
    Megatron sequence parallelism: residual-stream SEQ dims shard over
    the model axis, so all-reduces become all-gather + reduce-scatter of
    equal volume); "fsdp" (no tensor parallelism: model-axis
    constraints are dropped and the batch dim spans ("pod", "data",
    "model")). The JAX package keeps it process-global
    (``set_strategy``) because its models call ``constrain``; the
    port's caller (the collective count) passes its plan's.

    spec entries: None, a mesh axis name ("model"), BATCH (the
    ("pod","data") axes present; also "model" under fsdp) or SEQ
    ("model" under tp_sp)."""
    if mesh is None:
        return None
    names = set(mesh.axis_names)
    sizes = dict(mesh.shape)
    parts = []
    for dim, s in zip(shape, spec):
        if s is None:
            parts.append(None)
            continue
        if s == BATCH:
            batch_axes = ("pod", "data", "model") if strategy == "fsdp" \
                else ("pod", "data")
            axes = tuple(a for a in batch_axes if a in names)
        elif s == SEQ:
            axes = ("model",) if (strategy == "tp_sp"
                                  and "model" in names) else ()
        elif strategy == "fsdp" and s == "model":
            axes = ()
        else:
            axes = (s,) if s in names else ()
        n = 1
        for a in axes:
            n *= sizes[a]
        if axes and dim % n == 0:
            parts.append(axes if len(axes) > 1 else axes[0])
        else:
            parts.append(None)
    if all(p is None for p in parts):
        return None
    return tuple(parts)

"""Trees of tensors: the port's stand-in for JAX pytrees.

A tree is a nested dict whose leaves are tensors; an
``nn.Module`` inside one stands for the dict of its parameters, keyed by
their dotted names (``layers.0.attn.wq``). The optimizer and the
checkpoint walk trees through these helpers, in insertion order
(``named_parameters`` order for a module).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

from torch import nn

Tree = Any
Path = Tuple[str, ...]


def _node(tree: Tree):
    return dict(tree.named_parameters()) if isinstance(tree, nn.Module) \
        else tree


def flatten(tree: Tree, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs, depth first."""
    node = _node(tree)
    if isinstance(node, dict):
        for k, v in node.items():
            yield from flatten(v, prefix + (str(k),))
    else:
        yield prefix, node


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(flat: Dict[Path, Any]) -> dict:
    """Nested dicts from (path -> leaf) pairs: the structure of the tree
    that was flattened, a module's as the dict of its parameters."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


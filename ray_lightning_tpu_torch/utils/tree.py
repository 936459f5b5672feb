"""Nested dict / list / tuple trees of tensors: the port's stand-in for
``jax.tree_util`` where the trainer needs one."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf (containers rebuilt)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """Every leaf of ``tree``, in the containers' iteration order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]

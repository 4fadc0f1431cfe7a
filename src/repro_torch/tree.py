"""Pytrees of tensors: nested dicts, tuples and lists, as the reference's
params and optimizer state are nested."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` applied leaf by leaf to trees of one structure; the result keeps
    the first tree's nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in the order `tree_map` visits them."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]

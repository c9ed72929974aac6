"""Params trees: nested dicts and lists (or tuples) of tensors, the port's
counterpart of JAX pytrees for the functional train step, the optimizer
state and checkpoints.  Dict keys are visited in sorted order, as
``jax.tree`` visits them, so a tree's leaf order does not depend on how
its dicts were built."""
from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and trees of the same
    structure in ``rest``; dicts stay dicts, lists lists, tuples tuples.

    >>> tree_map(lambda a, b: a + b, {"w": 1, "l": [2, 3]},
    ...          {"w": 10, "l": [20, 30]})
    {'l': [22, 33], 'w': 11}
    """
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]

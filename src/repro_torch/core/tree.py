"""Params trees: nested dicts and lists (or tuples) of tensors, the port's
counterpart of JAX pytrees for the functional train step, the optimizer
state and checkpoints.  Dict keys are visited in sorted order, as
``jax.tree`` visits them, so a tree's leaf order does not depend on how
its dicts were built."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_flatten", "tree_unflatten"]


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


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``: the leaves in :func:`tree_map`'s order and a
    hashable description of the structure (dict keys, list and tuple
    arities), so two trees of one structure have equal treedefs.

    >>> leaves, td = tree_flatten({"w": 1, "l": [2, (3,)]})
    >>> leaves
    [2, 3, 1]
    >>> tree_unflatten(td, [20, 30, 10])
    {'l': [20, (30,)], 'w': 10}
    """
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([leaf for ls, _ in parts for leaf in ls],
                ("dict", keys, tuple(td for _, td in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(t) for t in tree]
        return ([leaf for ls, _ in parts for leaf in ls],
                (type(tree).__name__, tuple(td for _, td in parts)))
    return [tree], None


def tree_unflatten(treedef, leaves) -> Any:
    """The tree of ``treedef`` (from :func:`tree_flatten`) holding
    ``leaves`` in order."""
    it = iter(leaves)

    def build(td):
        if td is None:
            return next(it)
        if td[0] == "dict":
            return {k: build(t) for k, t in zip(td[1], td[2])}
        out = [build(t) for t in td[1]]
        return out if td[0] == "list" else tuple(out)

    return build(treedef)

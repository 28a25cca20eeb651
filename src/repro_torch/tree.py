"""Nested dicts of tensors as trees: the port's stand-in for ``jax.tree``.

Parameters, gradients and optimizer moments are nested dicts whose leaves
are tensors (or arrays); these helpers walk them in insertion order.
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, *trees) -> Any:
    """Apply ``fn`` leafwise over trees shaped like the first one."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in the order ``tree_map`` visits them."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]

"""Param trees: nested dicts, lists and tuples with array leaves.

Leaves are visited in JAX's order (dict keys sorted, sequences in
order), so a flat list of leaves lines up with ``jax.tree.leaves`` of
the same tree.  No torch here: CPU workers unpickle trees without it.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts (in sorted key order),
    lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree: Any, leaves: Sequence[Any]) -> Any:
    """``leaves`` (in ``tree_leaves`` order) in ``tree``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)

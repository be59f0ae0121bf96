"""Trees of tensors: nested dicts and lists, the port's stand-in for JAX's
pytrees.

The flattening order is JAX's: dict keys sorted, list items in order,
``None`` an empty subtree.  The optimizer's reductions and the checkpoint
keys follow it, so a sum over leaves adds them in the order
``jax.tree.leaves`` gives, and a leaf's checkpoint key is the one
``jax.tree_util.tree_flatten_with_path`` gives.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Sequence, Tuple

__all__ = ["leaves_with_paths", "tree_leaves", "tree_map", "tree_unflatten"]


def leaves_with_paths(tree: Any, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in JAX's order; a path holds dict keys and list
    indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of trees of one structure (tuples come back as
    lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_unflatten(tree: Any, leaves: Sequence[Any]) -> Any:
    """``tree``'s structure with its leaves replaced, in JAX's order, by
    ``leaves``."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            vals = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [rebuild(v) for v in t]
        return None if t is None else next(it)

    out = rebuild(tree)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out

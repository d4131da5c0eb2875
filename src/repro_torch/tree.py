"""Trees of tensors — nested dicts, as the params, grads and AdamW moments
are — walked in the JAX package's leaf order: a dict's keys sorted, as
``jax.tree_util`` flattens them. So a sum over the leaves adds them in the
reference's order, and a leaf's path is the key that the reference's
checkpoints store it under.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

__all__ = ["tree_map", "tree_paths", "tree_leaves", "tree_unflatten"]


def tree_map(f: Callable, tree: Any, *rest: Any) -> Any:
    """``f`` over the leaves of ``tree`` (and of the trees in ``rest``,
    which share its structure), called in leaf order."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return f(tree, *rest)


def tree_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} in leaf order; a path joins the dict keys with "/", as
    the reference's checkpoint ``_flatten`` does."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        out.update(tree_paths(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return list(tree_paths(tree).values())


def tree_unflatten(like: Any, leaves) -> Any:
    """``leaves`` (in leaf order) placed in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)

"""Nested dict / list / tuple trees of tensors: the few pytree utilities
the training path needs.

Leaves are visited in the JAX package's order (``jax.tree.leaves``: dict
keys sorted, sequences in order), so a sum over leaves adds in the same
order in both packages, and a leaf's path prints as ``jax.tree_util.
keystr`` prints it (``['body']['ffn']['wi']``, ``['prefix'][0]...``), so
checkpoint file names are the reference's.  ``None`` is an empty subtree,
as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree):
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in leaf order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, sub in kids:
        out.extend(leaves_with_path(sub, prefix + key))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (same
    structure), rebuilt in ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        # sorted: ``fn`` sees the leaves in leaf order
        return {k: map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def unflatten(like, leaves_: List[Any]):
    """A tree of ``like``'s structure holding ``leaves_`` in leaf order."""
    it = iter(leaves_)
    return map(lambda _: next(it), like)

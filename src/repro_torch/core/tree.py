"""Nested parameter trees (dicts, NamedTuples, lists of tensors) walked
in the JAX package's leaf order: dict keys sorted, NamedTuple fields and
sequence items in order.  Sums over the leaves (the global gradient
norm) run in that order in both packages."""

from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order (``None`` is
    an empty subtree, as in JAX)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if _is_namedtuple(tree) or isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure; the
    result has the structure of ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten(tree, flat):
    """``tree`` with its leaves replaced, in :func:`leaves` order, by
    the items of ``flat``."""
    it = iter(flat)

    def rebuild(t):
        if isinstance(t, dict):
            out = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(rebuild(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(it)
    return rebuild(tree)

"""Nested-dict trees of tensors: the port's stand-in for ``jax.tree``.

A tree is a dict whose values are trees or leaves; anything that is not a
dict is a leaf (a tensor, a :class:`~repro_torch.core.accumulator.ReproAcc`,
``None``).  Leaves come in the order ``jax.tree.leaves`` gives a dict of
the same keys: sorted keys, depth first.  That order matters for the bits:
the global gradient norm merges one accumulator per leaf in it.
"""
from __future__ import annotations

from typing import Callable, Iterator

__all__ = ["leaves", "paths", "tree_map", "tree_map_with_path",
           "from_paths"]


def paths(tree, prefix: tuple = ()) -> Iterator[tuple]:
    """``(path, leaf)`` pairs in leaf order; a path is a tuple of keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, *rest, prefix: tuple = ()):
    """``fn(path, leaf, *matching leaves)`` over a tree."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      prefix=prefix + (k,))
                for k in tree}
    return fn(prefix, tree, *rest)


def from_paths(items) -> dict:
    """The tree of ``(path, leaf)`` pairs (inverse of :func:`paths`)."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out

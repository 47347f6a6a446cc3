"""Nested containers of tensors ("trees"): parameters, gradients and
optimizer states are plain nested dicts, as in the JAX package.

Leaves are visited in the JAX package's order (dict keys sorted, lists
and tuples by index), so a walk over a tree here meets the leaves in the
order ``jax.tree_util.tree_leaves`` gives, and a path names a leaf as
the JAX package's checkpoints do.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *matching leaves of rest)`` over every leaf of ``tree``
    (the other trees have its structure, or more below its leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def flatten_with_path(tree: Any, prefix: tuple = ()) -> Iterator[tuple]:
    """(path, leaf) for every leaf, in the JAX package's order; a path is
    the tuple of dict keys and list indices leading to the leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_path(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_with_path(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in the JAX package's order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def map_with_path(fn: Callable, tree: Any, prefix: tuple = ()) -> Any:
    """``fn(path, leaf)`` over every leaf of ``tree``, paths as
    :func:`flatten_with_path` gives them."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def unflatten(tree: Any, flat: list) -> Any:
    """``flat`` (one value a leaf, in :func:`leaves` order) in ``tree``'s
    structure."""
    index = {path: i for i, (path, _) in enumerate(flatten_with_path(tree))}
    return map_with_path(lambda path, _: flat[index[path]], tree)

"""Nested containers of tensors: map, flatten, stack.

The JAX package treats states and observations as pytrees. Here a tree is
a tensor, ``None``, a tuple or list, a dict, or a dataclass of trees; a
dataclass is rebuilt through its constructor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied to each leaf of ``tree`` and the matching leaves of
    ``rest`` (same structure)."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(template, leaves):
    """A tree shaped as ``template`` holding ``leaves`` (``tree_leaves``'s
    inverse)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def tree_stack(trees):
    """One tree whose leaves stack the given trees' leaves on a new first
    axis (batch-first)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def stack_rows(rows):
    """Rows of equal tuples of trees (e.g. one per step) -> one tuple whose
    trees stack the rows' on a new first axis."""
    return tuple(tree_stack(xs) for xs in zip(*rows))


def tree_index(tree, i):
    """Entry ``i`` along the first axis of every leaf."""
    return tree_map(lambda x: x[i], tree)

"""Trees of tensors: nested dicts, lists, tuples and dataclasses, walked
in the order `jax.tree_util` walks the reference's pytrees (dict keys
sorted, sequences by index, dataclass fields in declaration order), so
leaf order and leaf names agree with the reference's.

A leaf's path is a tuple of entries: a dict key (str), a sequence index
(int) or a dataclass field, written `.name` as JAX's `GetAttrKey`
prints it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Tuple


def _children(node) -> List[Tuple[Any, Any]]:
    """(path entry, child) of an inner node, in JAX's order; [] for a
    leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return []


def _is_leaf(node) -> bool:
    return not isinstance(node, (dict, list, tuple)) and not (
        dataclasses.is_dataclass(node) and not isinstance(node, type))


def leaves_with_path(tree, prefix=()) -> Iterator[Tuple[tuple, Any]]:
    """(path, leaf) of every leaf, in order."""
    if _is_leaf(tree):
        yield prefix, tree
        return
    for key, child in _children(tree):
        yield from leaves_with_path(child, prefix + (key,))


def path_name(path) -> str:
    """A leaf's name: its path's entries joined by "/" (the reference's
    checkpoint leaf names, e.g. ".opt/.m/layers/wq")."""
    return "/".join(str(p) for p in path)


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """A tree of `tree`'s structure with fn(leaf, *the other trees'
    leaves at the same place) at each leaf."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):      # visited sorted, keeps its order
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return dataclasses.replace(tree, **{
        f.name: tree_map(fn, getattr(tree, f.name),
                         *(getattr(r, f.name) for r in rest))
        for f in dataclasses.fields(tree)})


def tree_unflatten(tree, leaves):
    """`tree`'s structure with `leaves` (in `tree_leaves` order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out

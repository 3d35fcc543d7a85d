"""Nested containers of tensors, walked in JAX's pytree order.

The port keeps the reference's orders where they reach a record: the
checkpoint's array names and ``meta.json``, the labels of a weight
broadcast, a payload's bytes on the scheduler's links.  JAX visits a dict's
keys sorted, a list or tuple in order, a ``QTensor``'s values then scales
and a ``CTensor``'s values then mask (registered nodes, their children by
position), and treats ``None`` as an empty node; every other object is a
leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

from repro_torch.core.plugins import CTensor, QTensor

__all__ = ["flatten_with_paths", "path_key", "tree_map_with_path",
           "unflatten", "leaves"]

# a path is a tuple of ("key", dict key) / ("idx", position) entries


def _children(tree) -> Tuple:
    """A payload carrier's children, in the reference's flattening order."""
    if isinstance(tree, QTensor):
        return (tree.values, tree.scales)
    return (tree.values, tree.mask)


def _walk(tree, path, out: List[Tuple[Tuple, Any]]):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], path + (("key", k),), out)
    elif isinstance(tree, (list, tuple, QTensor, CTensor)):
        children = (tree if isinstance(tree, (list, tuple))
                    else _children(tree))
        for i, v in enumerate(children):
            _walk(v, path + (("idx", i),), out)
    else:
        out.append((path, tree))


def flatten_with_paths(tree) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf), ...]`` in JAX's order."""
    out: List[Tuple[Tuple, Any]] = []
    _walk(tree, (), out)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def path_key(path) -> str:
    """The reference's checkpoint name of a leaf: its keys and positions
    joined by ``/``."""
    return "/".join(str(v) for _, v in path)


def _rebuild(tree, it):
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: new[k] for k in tree}          # the caller's key order
    if isinstance(tree, (list, tuple)):
        children = [_rebuild(v, it) for v in tree]
        if isinstance(tree, list):
            return children
        return (type(tree)(*children) if hasattr(tree, "_fields")
                else type(tree)(children))
    if isinstance(tree, (QTensor, CTensor)):
        return type(tree)(*(_rebuild(v, it) for v in _children(tree)))
    return next(it)


def unflatten(template, new_leaves) -> Any:
    """``template``'s structure with its leaves replaced, in order."""
    return _rebuild(template, iter(new_leaves))


def tree_map_with_path(fn: Callable, tree, *rest) -> Any:
    """``fn(path, leaf, *matching leaves of rest)`` over every leaf."""
    flat = flatten_with_paths(tree)
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(p, leaf, *(o[i] for o in others))
                            for i, (p, leaf) in enumerate(flat)])

"""Trees of tensors: the subset of ``jax.tree_util`` the port's optimizer,
checkpointer and conversions need, with JAX's flattening rules.

A tree is a dict, a list, a tuple, a NamedTuple or ``None`` holding trees;
anything else is a leaf.  Dicts flatten in sorted key order and ``None`` has
no leaves, as in JAX.  A leaf's key is its path joined by ``/``: a dict key
as itself, a sequence index as its number, a NamedTuple field as ``.`` and
its name, which is what ``jax.tree_util.tree_flatten_with_path`` gives and
``src/repro/checkpoint/checkpoint.py`` writes.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> list[tuple[str, Any]] | None:
    """(path part, child) of a tree node, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _rebuild(node, children: list) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def flatten_with_path(tree: Any) -> list[tuple[str, Any]]:
    """Every (key, leaf) of ``tree`` in JAX's order."""
    out: list[tuple[str, Any]] = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append(("/".join(path), node))
            return
        for part, child in kids:
            walk(child, (*path, part))

    walk(tree, ())
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(template: Any, new_leaves) -> Any:
    """``template``'s structure with its leaves replaced, in order."""
    it = iter(new_leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(c) for _, c in kids])

    out = build(template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template has")
    return out


def flatten_up_to(template: Any, tree: Any) -> list:
    """The subtrees of ``tree`` at the leaves of ``template`` (JAX's
    ``treedef.flatten_up_to``)."""
    out: list = []

    def walk(t, node):
        kids = _children(t)
        if kids is None:
            out.append(node)
            return
        other = _children(node)
        if other is None or [p for p, _ in other] != [p for p, _ in kids]:
            raise ValueError("tree structures differ")
        for (_, tc), (_, nc) in zip(kids, other):
            walk(tc, nc)

    walk(template, tree)
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest``."""
    others = [flatten_up_to(tree, r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others)])

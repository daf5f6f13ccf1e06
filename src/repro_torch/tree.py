"""Nested dicts, lists and tuples of leaves: the port's parameter trees.

The JAX package walks its parameters with ``jax.tree_util``; the port's
trees are plain containers, walked here in the same order (dict keys
sorted, sequences in order). ``path_name`` spells a leaf's path as the
reference's checkpoint manifest does (``['groups']/[0]/['w']``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["leaves_with_paths", "tree_leaves", "tree_map", "tree_flatten",
           "tree_unflatten", "path_name"]


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def leaves_with_paths(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in traversal order; a path holds dict keys (str)
    and sequence indices (int)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], path + (k,))
        return out
    if _is_node(tree):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_paths(v, path + (i,))
        return out
    return [(path, tree)]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same places of the
    trees in ``rest``), keeping the containers."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_node(tree):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_flatten(tree):
    """(leaves, treedef): ``treedef`` is the tree with its leaves
    replaced by None, for :func:`tree_unflatten`."""
    return tree_leaves(tree), tree_map(lambda _: None, tree)


def tree_unflatten(treedef, leaves):
    """The tree of :func:`tree_flatten`'s ``treedef`` with ``leaves``."""
    return _build(treedef, iter(leaves))


def _build(node, it):
    # a module function, not a closure over itself: a self-referencing
    # closure is a reference cycle, which would hold ``leaves`` (a step's
    # gradients, say) until the cyclic collector ran
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if _is_node(node):
        return type(node)([_build(v, it) for v in node])
    return next(it)


def path_name(path: Tuple) -> str:
    """The reference's leaf name: ``['key']`` for a dict key, ``[i]`` for
    a sequence index, joined by ``/``."""
    return "/".join(f"[{k}]" if isinstance(k, int) else f"['{k}']"
                    for k in path)

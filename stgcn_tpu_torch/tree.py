"""Nested dict/list trees of tensors: the port's parameter dictionaries in
the JAX package's layout (``{"blocks": [...], "fc": {...}}``)."""

from __future__ import annotations


def tree_map(fn, tree):
    """``fn`` applied to every leaf, the dict/list structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves in a fixed order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]

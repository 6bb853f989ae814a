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


def tree_items(tree, prefix: str = "") -> dict:
    """``{"a/b/0": leaf}`` for every leaf, keyed by its path (the JAX
    package's checkpoint key paths), in :func:`tree_leaves`' order."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(tree_items(v, f"{prefix}/{k}" if prefix else str(k)))
    return out

"""Nested dicts and lists of tensors (the reference's pytrees of parameters
and training state), walked in ``jax.tree_util``'s order: dict keys sorted,
list items by index. A leaf's path is the reference's
``jax.tree_util.keystr``: ``['attn']['wq']``, ``['slots'][0]['ln1']``."""
from __future__ import annotations


def keystr(path: tuple) -> str:
    return "".join(f"[{k!r}]" for k in path)


def leaves_with_paths(tree, path: tuple = ()) -> list[tuple[str, object]]:
    """``[(keystr, leaf), …]`` in the reference's order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves_with_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in leaves_with_paths(v, path + (i,))]
    return [(keystr(path), tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure); the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(keystr, leaf)`` over the leaves; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(keystr(path), tree)

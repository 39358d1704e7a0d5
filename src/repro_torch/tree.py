"""Nested containers of tensors ("trees"), flattened in the JAX package's
order.

`jax.tree_util` flattens a dict in sorted key order and a tuple or list in
index order, and treats None as an empty subtree. The port's params,
optimizer state and checkpoints are the same plain dicts and tuples, so
these helpers flatten them in the same order: a checkpoint's `a<i>` arrays
and its manifest's paths line up leaf for leaf in both packages.
"""

from __future__ import annotations

from typing import Any, Callable


def _children(node) -> list | None:
    """(key, child) pairs of a container, None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    return None


def flatten_with_path(tree: Any) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in the JAX package's flattening order; a path is the
    tuple of dict keys and sequence indices from the root."""
    out: list = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for k, v in kids:
            walk(v, path + (k,))

    walk(tree, ())
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def path_str(path: tuple) -> str:
    """"a/b/0/c", as the JAX package joins a key path."""
    return "/".join(str(p) for p in path)


def unflatten(like: Any, new_leaves) -> Any:
    """A tree shaped like `like` whose leaves are `new_leaves`, in
    flattening order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}       # keep the key order
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` and the matching leaves of `rest`."""
    others = [leaves(r) for r in rest]
    flat = leaves(tree)
    if any(len(o) != len(flat) for o in others):
        raise ValueError("tree_map: trees of different structure")
    return unflatten(tree, [fn(*args) for args in zip(flat, *others)])


def map_with_path(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """`fn(path_str, leaf)` over the leaves of `tree`."""
    return unflatten(tree, [fn(path_str(p), leaf)
                            for p, leaf in flatten_with_path(tree)])

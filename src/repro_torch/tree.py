"""Pytrees of the port: nested dicts, lists, tuples and NamedTuples of
tensors (or numpy arrays), walked in ``jax.tree_util``'s order so that
the port and the reference see the same leaves in the same order: dict
keys sorted, NamedTuple fields and sequence items in order, ``None`` an
empty subtree.

``flatten_with_path`` names each leaf as the reference's checkpoint
manager names it (``_tensor_key`` of ``tree_flatten_with_path``): dict
keys as themselves, NamedTuple fields as ``.name``, sequence items by
index, joined with ``/`` — ``.params/blocks/wq``, ``.opt/.step``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree: Any, prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[str, Any]]:
    """``[(key, leaf), ...]`` in ``jax.tree_util`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_path(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for name in tree._fields
                for kv in flatten_with_path(getattr(tree, name),
                                            prefix + ("." + name,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in flatten_with_path(x, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like: Any, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` (an iterable
    in ``leaves(like)`` order)."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``jax.tree.map``: ``fn`` over the leaves of ``tree`` and the
    matching leaves of ``rest`` (trees of the same structure)."""
    others = [leaves(r) for r in rest]
    own = leaves(tree)
    if any(len(o) != len(own) for o in others):
        raise ValueError("tree_map: trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(own, *others)])


__all__ = ["flatten_with_path", "leaves", "unflatten", "tree_map"]

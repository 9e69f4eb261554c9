"""Nested containers of tensors, walked by ``jax.tree`` rules: dict keys in
sorted order, lists and tuples in order, a NamedTuple by field, ``None``
holding no leaf. One walker for the package: checkpoints number their
leaves by it, and the input pipeline places a batch's arrays with it."""

from __future__ import annotations

from typing import Any, Callable, List, Optional


def leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
           ) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order; ``is_leaf``
    marks containers that count as one leaf (a spec tree's
    PartitionSpecs, which are tuples)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in leaves(tree[key], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for child in tree for leaf in leaves(child, is_leaf)]
    return [tree]


def unflatten(template: Any, values) -> Any:
    """``template``'s structure with its leaves taken in order from the
    iterator ``values``."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {key: unflatten(template[key], values)
               for key in sorted(template)}
        return {key: out[key] for key in template}
    if isinstance(template, list):
        return [unflatten(child, values) for child in template]
    if isinstance(template, tuple):
        children = [unflatten(child, values) for child in template]
        if hasattr(template, "_fields"):                  # a NamedTuple
            return type(template)(*children)
        return tuple(children)
    return next(values)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree``'s structure with ``fn`` applied to each leaf."""
    return unflatten(tree, iter([fn(leaf) for leaf in leaves(tree)]))

"""Parameter and state trees: nested dicts, lists and tuples of tensors,
with ``None`` for an empty subtree.

Leaves are walked in the JAX package's flatten order (``jax.tree_util``):
dict keys sorted, sequences in order, ``None`` holding no leaf. So leaf
``i`` here is leaf ``i`` there: a sum over leaves (the optimizers' global
norm) adds in the same order, and checkpoints number their files alike.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def flatten_up_to(structure: Any, tree: Any) -> List[Any]:
    """The subtrees of ``tree`` at the leaves of ``structure``, in flatten
    order (``treedef.flatten_up_to``): for a per-leaf state such as
    Adafactor's ``{"vr", "vc"}`` dicts, one dict a parameter."""
    if structure is None:
        return []
    if isinstance(structure, dict):
        return [x for k in sorted(structure) for x in flatten_up_to(structure[k], tree[k])]
    if isinstance(structure, (list, tuple)):
        if len(structure) != len(tree):
            raise ValueError(f"sequence of {len(tree)} where the structure has {len(structure)}")
        return [x for s, t in zip(structure, tree) for x in flatten_up_to(s, t)]
    return [tree]


def tree_leaves(tree: Any) -> List[Any]:
    """Every leaf of ``tree`` in flatten order; ``None`` has none."""
    return flatten_up_to(tree, tree)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *matching subtrees of rest)`` at every leaf of ``tree``,
    keeping its structure; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(structure: Any, leaves: List[Any]) -> Any:
    """``structure`` with its leaves replaced, in flatten order, by
    ``leaves``."""
    it = iter(leaves)
    out = _fill(structure, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the structure holds")
    return out


_END = object()


def _fill(structure: Any, it: Iterator) -> Any:
    if structure is None:
        return None
    if isinstance(structure, dict):
        filled = {k: _fill(structure[k], it) for k in sorted(structure)}
        return {k: filled[k] for k in structure}
    if isinstance(structure, (list, tuple)):
        return type(structure)(_fill(s, it) for s in structure)
    leaf = next(it, _END)
    if leaf is _END:
        raise ValueError("fewer leaves than the structure holds")
    return leaf

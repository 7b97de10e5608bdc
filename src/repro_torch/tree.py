"""Nested params as plain containers: dicts, lists and tuples of tensors.

``repro`` keeps its params and optimizer state as JAX pytrees; the port keeps
the same nesting in plain Python containers and walks them here.  The leaf
order is JAX's (dict keys sorted, sequences in order), and a leaf's path is
the keys and indices on the way to it joined by ``/`` (``"tables/0/q"``),
as ``repro.checkpoint.checkpointer`` names them, so a checkpoint's leaves
line up between the two packages.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def leaves_with_paths(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flatten order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_paths(tree[key], f"{prefix}{key}/")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from leaves_with_paths(item, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def leaves(tree: Any) -> list:
    return [leaf for _path, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the containers are rebuilt."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def unflatten(like: Any, values: list) -> Any:
    """A tree of ``like``'s structure whose leaves are ``values`` in order."""
    it = iter(values)
    out = tree_map(lambda _leaf: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out

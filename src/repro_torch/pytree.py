"""Nested containers of tensors (dicts, lists, tuples and NamedTuples): the
tree operations the training path needs, the port's stand-in for
``jax.tree_util``.  Trees are walked as JAX walks them, dict keys sorted, so
checkpoint leaf names follow the reference's rule; ``None`` is an empty
subtree."""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` pairs: a path holds dict keys, NamedTuple field names
    and sequence indices, as strings."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten_with_path(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for name, v in zip(tree._fields, tree)
                for kv in flatten_with_path(v, path + (name,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in flatten_with_path(v, path + (str(i),))]
    if tree is None:
        return []
    return [(path, tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each tree
    in ``rest`` (same structure), visited in ``flatten_with_path``'s order."""
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def unflatten_like(tree, values: Sequence[Any]):
    """A tree of ``tree``'s structure holding ``values`` in its leaf order."""
    it = iter(values)
    out = tree_map(lambda _: next(it), tree)
    if next(it, it) is not it:
        raise ValueError("more values than the tree has leaves")
    return out

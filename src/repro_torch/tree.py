"""Nested dicts (and lists / tuples) of tensors as the JAX package's pytrees.

JAX flattens a dict in sorted key order. The optimizer's global norm, the
checkpoint's keys and the tests' leaf-by-leaf comparisons follow that order,
whatever order the port's dicts were built in. Only plain lists and tuples
are nodes: a tuple subclass (a sharding spec ``P``, a ``torch.Size``) is a
leaf, as JAX's ``is_leaf=lambda x: isinstance(x, P)`` makes it.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

_SEQUENCES = (list, tuple)

Path = Tuple[Any, ...]


def tree_flatten_with_path(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in JAX's order: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_flatten_with_path(tree[k], prefix + (k,))]
    if type(tree) in _SEQUENCES:
        return [pl for i, x in enumerate(tree) for pl in tree_flatten_with_path(x, prefix + (i,))]
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``,
    in a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if type(tree) in _SEQUENCES:
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_replace_leaves(tree: Any, leaves: list) -> Any:
    """A tree of ``tree``'s structure whose leaves, in JAX's order, are ``leaves``."""
    it = iter(leaves)
    order = {path: next(it) for path, _ in tree_flatten_with_path(tree)}
    return _rebuild(tree, (), order)


def _rebuild(t: Any, prefix: Path, order: dict) -> Any:
    # module level, not a closure: a nested function that calls itself is a
    # reference cycle, which would keep ``order`` (the new leaves: a whole
    # tree of parameters or moments in AdamW) alive until a GC pass
    if isinstance(t, dict):
        return {k: _rebuild(v, prefix + (k,), order) for k, v in t.items()}
    if type(t) in _SEQUENCES:
        return type(t)(_rebuild(v, prefix + (i,), order) for i, v in enumerate(t))
    return order[prefix]


def path_key(path: Path) -> str:
    """The checkpoint key of a leaf: its path's keys joined by "/"."""
    return "/".join(str(p) for p in path)


def treedef_str(tree: Any) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for a tree of dicts,
    lists and tuples, e.g. ``PyTreeDef({'a': *, 'b': [*, *]})``."""
    def render(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {render(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(render(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(render(v) for v in t)
            return "(" + inner + ("," if len(t) == 1 else "") + ")"
        return "*"

    return f"PyTreeDef({render(tree)})"

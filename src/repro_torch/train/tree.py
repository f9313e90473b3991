"""Nested dicts and lists of tensors as the JAX package's pytrees: the
order of their leaves and the paths that name them.

JAX flattens a dict in the order of its sorted keys, a list or tuple in
its own order, and drops ``None`` (a node without children, such as the
optimizer's ``master`` of an fp32 leaf). A leaf's path is
``jax.tree_util.keystr`` of its key path, ``"['stacks'][0][0]['attn']['wq']"``.
A checkpoint written by either package restores in the other only when
both agree on these, so the optimizer, the gradient compression and the
checkpoints of the port all flatten through this module."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def leaves_with_paths(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, f"{path}[{i}]")
    else:
        yield path, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like: Any, new_leaves) -> Any:
    """A tree of ``like``'s structure whose leaves are ``new_leaves`` in
    flattening order (``None`` where ``like`` has ``None``)."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}     # the caller's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def flatten_up_to(like: Any, tree: Any) -> List[Any]:
    """The parts of ``tree`` at the leaf positions of ``like`` in
    flattening order, ``None`` where ``tree`` holds ``None`` (JAX's
    ``treedef.flatten_up_to``: the optimizer's ``master`` against the
    parameters)."""
    out: List[Any] = []

    def walk(l, t):
        if l is None:
            return
        if isinstance(l, dict):
            for k in sorted(l):
                walk(l[k], None if t is None else t[k])
        elif isinstance(l, (list, tuple)):
            for i, v in enumerate(l):
                walk(v, None if t is None else t[i])
        else:
            out.append(t)
    walk(like, tree)
    return out

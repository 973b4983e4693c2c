"""The port's parameter and optimizer trees: dicts, lists and named tuples
of tensors, walked in the order they hold their leaves.  A leaf's path
joins dict keys, list indices and tuple field names with "/"
(``layers/0/mixer/wq``, ``opt/mu/embed/table``)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if hasattr(tree, "_fields"):                          # a NamedTuple
        return list(zip(tree._fields, tree))
    return [(str(i), v) for i, v in enumerate(tree)]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def tree_items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs, in order."""
    if not _is_node(tree):
        yield prefix, tree
        return
    for k, v in _children(tree):
        yield from tree_items(v, f"{prefix}/{k}" if prefix else k)


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       prefix: str = "") -> Any:
    """A tree of the same structure with ``fn(path, leaf)`` at each leaf."""
    if not _is_node(tree):
        return fn(prefix, tree)
    out = [(k, tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else k))
           for k, v in _children(tree)]
    if isinstance(tree, dict):
        return {k0: v for k0, (_, v) in zip(tree, out)}
    if hasattr(tree, "_fields"):
        return type(tree)(*(v for _, v in out))
    return [v for _, v in out]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)

"""Nested-container helpers: the port's stand-in for ``jax.tree_util``.

Parameter trees are nested dicts of tensors (JAX's layouts, stacked layer
axis first); SLR state and deployed weights are dataclasses. Dict keys are
walked in sorted order, as ``jax.tree_util`` flattens dicts, so leaf paths
and their order match the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import torch

__all__ = ["tree_map", "tree_leaves_with_path", "leaf_by_path", "replace_by_path"]


def tree_map(fn: Callable[[torch.Tensor], Any], obj: Any) -> Any:
    """Apply ``fn`` to every tensor inside dicts, lists, tuples, named
    tuples and dataclasses; other values pass through unchanged."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(tree_map(fn, v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_map(fn, v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init
        }
        return dataclasses.replace(obj, **changes)
    return obj


def tree_leaves_with_path(tree: Any) -> Iterator[tuple[tuple, Any]]:
    """(key path, leaf) pairs of a nested dict/list tree, dict keys sorted.
    Anything that is not a dict or list is a leaf."""
    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            for i, v in enumerate(node):
                yield from walk(v, path + (i,))
        else:
            yield path, node

    yield from walk(tree, ())


def leaf_by_path(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def replace_by_path(tree: Any, fn: Callable[[tuple, Any], Any]) -> Any:
    """Rebuild a nested dict/list tree with ``fn(path, leaf)`` at every leaf
    (the counterpart of ``jax.tree_util.tree_map_with_path``)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            return type(node)(walk(v, path + (i,)) for i, v in enumerate(node))
        return fn(path, node)

    return walk(tree, ())

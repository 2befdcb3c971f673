"""Nested dicts, lists and tuples of tensors: the port's stand-in for
``jax.tree`` (params, optimizer state, decode caches and a captured
graph's inputs are such trees). Imports only torch and the standard
library, so every layer of the port can use it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch


def map_tree(fn: Callable, *trees):
    """Apply ``fn`` leaf-wise over nested dicts/lists/tuples (NamedTuples
    too) of tensors of the same structure (the port's stand-in for
    ``jax.tree.map``)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(map_tree(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, (list, tuple)):
        return type(t0)(map_tree(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def map_tree_with_path(fn: Callable, *trees, _path: Tuple = ()):
    """:func:`map_tree` with each leaf's path, a tuple of dict keys, list
    indices and NamedTuple field names, as ``fn``'s first argument (the
    port's ``jax.tree_util.tree_map_with_path``)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: map_tree_with_path(fn, *(t[k] for t in trees),
                                      _path=_path + (k,)) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(map_tree_with_path(fn, *xs, _path=_path + (f,))
                          for f, xs in zip(t0._fields, zip(*trees))))
    if isinstance(t0, (list, tuple)):
        return type(t0)(map_tree_with_path(fn, *xs, _path=_path + (i,))
                        for i, xs in enumerate(zip(*trees)))
    return fn(_path, *trees)


def path_key(path: Tuple) -> str:
    """A leaf's path as one string, ``"blocks/0/p0/ffn/w_in"``."""
    return "/".join(str(k) for k in path)


def flatten_tree(tree) -> Dict[str, Any]:
    """{:func:`path_key`: leaf} in :func:`map_tree`'s order."""
    out: Dict[str, Any] = {}
    map_tree_with_path(lambda path, leaf: out.__setitem__(path_key(path),
                                                          leaf), tree)
    return out


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    raise TypeError(f"graph inputs are tensors in dicts, lists and tuples; "
                    f"got {type(tree).__name__}")

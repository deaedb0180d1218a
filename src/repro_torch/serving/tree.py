"""The carry as a tree of tensors: the walk the round graphs, the sharded
session and the policies share (NamedTuples, dataclasses, tuples and dicts
of tensors)."""
from __future__ import annotations

import dataclasses

import torch


def tree_leaves(tree) -> list:
    """The tensors of a carry (NamedTuples, dataclasses and tuples of
    tensors, walked in field order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in tree_leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tree_leaves(x)]
    return []


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each of its tensors, its NamedTuples,
    dataclasses, tuples and dicts rebuilt around them."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        vals = [tree_map(fn, x) for x in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree

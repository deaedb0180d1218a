"""Parameter specs, their materialisation and their blocks on a mesh: port
of ``repro/models/params.py`` (``ParamSpec``, ``init_params``,
``count_params``, ``shardings``).

A model is a tree (nested dicts and lists) of :class:`ParamSpec` leaves.
:func:`init_params` draws each normal leaf in float32 from an explicit
``torch.Generator`` on the target device and casts it, one tensor at a
time, so a large model never holds more than one float32 leaf beside its
weights.  A leaf of more than ``CHUNKED_DRAW_ELEMENTS`` (2^32) elements —
Moonshot's stacked experts, 8.9e9 each — is drawn one slice of its leading
axis at a time straight into a tensor of its own dtype, so its float32
temporary is one slice; every smaller leaf keeps its whole draw.

Serving weights are stored once in the compute dtype (``dtype`` of
:func:`init_params`) instead of being cast on every use: the reference casts
each weight to the compute dtype inside every einsum (``.astype(dt)``),
which gives the same numbers.  The norm scales, which the reference reads in
float32, are specs with ``dtype="float32"`` and stay float32.

Each spec names the logical axis of every dim (``axes``, the reference's;
``()`` where undeclared, read as all None).  :func:`shardings` turns a
spec tree into each leaf's :class:`~repro_torch.sharding.rules.Placement`
under a rule table, :func:`shard_leaf` cuts this rank's block of a whole
leaf and :func:`gather_leaf` assembles the whole leaf from the ranks'
blocks.  ``init_params(..., placements=, mesh=)`` draws the whole tree on
every rank, in the same order from the same generator, and keeps each
leaf's block as soon as it is drawn: every world starts from the same
numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.collectives import all_gather, shard_index
from repro_torch.sharding.rules import Placement, ShardingRules


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: Optional[str] = None   # None: the dtype given to init_params
    init: str = "normal"          # normal | zeros | ones
    stddev: float = 0.02
    axes: tuple = ()              # one logical axis name (or None) a dim

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} for shape {self.shape}")


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/lists (``rest``: trees
    of the same structure, mapped alongside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def leaf_dtype(spec: ParamSpec, dtype: torch.dtype) -> torch.dtype:
    return dtype if spec.dtype is None else getattr(torch, spec.dtype)


CHUNKED_DRAW_ELEMENTS = 2 ** 32


def init_params(specs, generator: torch.Generator, device="cuda",
                dtype: torch.dtype = torch.float32, *, placements=None,
                mesh=None):
    """Materialise a spec tree: zeros, ones, or normal draws at each spec's
    ``stddev`` (float32 on ``device`` from ``generator``, which must live on
    that device, then cast to the leaf's dtype; a leaf of more than
    ``CHUNKED_DRAW_ELEMENTS`` elements one slice of its leading axis at a
    time).  An integer leaf (int8 expert weights) gets the cast's
    truncation toward zero, as the reference's ``astype``.  With
    ``placements`` (:func:`shardings`) and ``mesh``, each leaf is drawn
    whole and only this rank's block is kept."""
    dev = resolve_device(device)

    def draw(shape, stddev, dt):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return w.mul_(stddev).to(dt)

    def make(spec: ParamSpec):
        dt = leaf_dtype(spec, dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        if math.prod(spec.shape) <= CHUNKED_DRAW_ELEMENTS:
            return draw(spec.shape, spec.stddev, dt)
        out = torch.empty(spec.shape, dtype=dt, device=dev)
        for i in range(spec.shape[0]):
            out[i] = draw(spec.shape[1:], spec.stddev, dt)
        return out

    if placements is None:
        return tree_map(make, specs)
    return tree_map(lambda spec, pl: shard_leaf(make(spec), pl, mesh),
                    specs, placements)


def shardings(specs, mesh, rules: ShardingRules):
    """Each leaf's placement on ``mesh`` under ``rules`` (the reference's
    ``fitted_sharding`` of the leaf's axes and shape)."""
    return tree_map(lambda s: rules.placement(
        s.axes or (None,) * len(s.shape), s.shape), specs)


def _block_bounds(placement: Placement, mesh) -> list:
    """(dim, start, length) of this rank's block, one a split dim."""
    out = []
    for dim, axes in enumerate(placement.dims):
        if not axes:
            continue
        index, count = 0, 1
        for a in axes:          # the first mesh dim is the major one
            n = mesh.size(mesh.mesh_dim_names.index(a))
            index, count = index * n + shard_index(mesh, a), count * n
        length = placement.shape[dim] // count
        out.append((dim, index * length, length))
    return out


def block_shape(placement: Placement, mesh) -> tuple:
    """The shape of this rank's block of a leaf."""
    shape = list(placement.shape)
    for dim, _, length in _block_bounds(placement, mesh):
        shape[dim] = length
    return tuple(shape)


def block_start(placement: Placement, mesh) -> tuple:
    """Where this rank's block starts in the whole leaf, a dim each."""
    start = [0] * len(placement.shape)
    for dim, first, _ in _block_bounds(placement, mesh):
        start[dim] = first
    return tuple(start)


def block_view(full: torch.Tensor, placement: Placement, mesh):
    """This rank's block of the whole leaf ``full``, as a view of it."""
    if tuple(full.shape) != placement.shape:
        raise ValueError(f"leaf of shape {tuple(full.shape)} for a placement "
                         f"of {placement.shape}")
    out = full
    for dim, first, length in _block_bounds(placement, mesh):
        out = out.narrow(dim, first, length)
    return out


def shard_leaf(full: torch.Tensor, placement: Placement, mesh):
    """This rank's block of the whole leaf ``full`` (a tensor of its own:
    no view of ``full``); ``full`` itself where nothing splits it."""
    out = block_view(full, placement, mesh)
    if out.shape == full.shape:
        return full
    return out.clone(memory_format=torch.contiguous_format)


def gather_leaf(block: torch.Tensor, placement: Placement, mesh):
    """The whole leaf from every rank's ``block``: an ``all_gather`` along
    each split dim, over its mesh dims from the minor one out.  A
    collective call: every rank of the split dims' groups makes it."""
    out = block
    for dim, axes in enumerate(placement.dims):
        for a in reversed(axes):
            out = all_gather(out, mesh, a, dim=dim)
    return out


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))

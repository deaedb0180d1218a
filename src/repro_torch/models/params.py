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

A split forward reads a leaf through its compute view (:func:`compute_view`:
this rank's ``"model"`` block gathered over ``"data"`` only, or the whole
leaf where the layer's plan reads it whole), one layer of a stacked leaf at
a time (:class:`MeshLeaf`): no caller gathers the whole tree.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.collectives import all_gather, shard_count, \
    shard_index
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


# ---------------------------------------------------------------------------
# Compute views: what a split forward reads of a leaf
# ---------------------------------------------------------------------------
def _gathered_axes(placement: Placement, whole: bool) -> list:
    """(dim, mesh dim) of each gather that makes the compute view: every
    mesh dim but ``"model"``, and ``"model"`` too when ``whole``.  A dim
    split by ``"model"`` and another mesh dim has no contiguous
    ``"model"`` block to keep."""
    out = []
    for dim, axes in enumerate(placement.dims):
        if "model" in axes and len(axes) > 1 and not whole:
            raise ValueError(f"dim {dim} of a leaf of {placement.shape} is "
                             f"split by {axes}: its \"model\" block is not "
                             f"contiguous")
        out += [(dim, a) for a in reversed(axes) if whole or a != "model"]
    return out


def view_shape(placement: Placement, mesh, whole: bool) -> tuple:
    """The shape of this rank's compute view of a leaf (:func:`compute_view`)."""
    shape = list(block_shape(placement, mesh))
    for dim, a in _gathered_axes(placement, whole):
        shape[dim] *= mesh.size(mesh.mesh_dim_names.index(a))
    return tuple(shape)


def compute_view(block: torch.Tensor, placement: Placement, mesh,
                 dtype: torch.dtype, whole: bool = False):
    """This rank's compute view of a leaf from its ``block``: cast to
    ``dtype``, then gathered over every mesh dim but ``"model"`` (its
    ``"model"`` block, whole over ``"data"``), or over all of them where
    ``whole``.  A collective call over the gathered dims' groups."""
    out = block.to(dtype)
    for dim, a in _gathered_axes(placement, whole):
        out = all_gather(out, mesh, a, dim=dim)
    return out


def layer_placement(placement: Placement) -> Placement:
    """The placement of one layer of a stacked leaf (its leading
    ``layers`` dim, which no mesh dim splits, dropped)."""
    if placement.dims[0]:
        raise ValueError(f"a stacked leaf split along its layers: "
                         f"{placement.dims}")
    return Placement(placement.shape[1:], placement.dims[1:])


def axis_block(t: torch.Tensor, placement: Placement, mesh, axis: str):
    """This rank's block along mesh dim ``axis`` of ``t``, a tensor that
    holds whole every dim that ``axis`` splits (the others as they are)."""
    out = t
    for dim, axes in enumerate(placement.dims):
        if axis in axes:
            n = out.shape[dim] // shard_count(mesh, axis)
            out = out.narrow(dim, shard_index(mesh, axis) * n, n)
    return out


class GatherLive:
    """Which units (a layer, the embedding, the head) have a gathered or
    cast copy of a leaf alive, and the most at once since :meth:`reset`."""

    def __init__(self):
        self.live: dict = {}
        self.peak = 0
        self.gathers = 0

    def reset(self):
        self.peak, self.gathers = len(self.live), 0

    def add(self, tag):
        self.live[tag] = self.live.get(tag, 0) + 1
        self.gathers += 1
        self.peak = max(self.peak, len(self.live))

    def drop(self, tag):
        self.live[tag] -= 1
        if not self.live[tag]:
            del self.live[tag]


GATHERED = GatherLive()
# storage pointer -> how to make the copy again, for copies alive now
_REMAKE: dict = {}


def _released(key: int, tag):
    _REMAKE.pop(key, None)
    GATHERED.drop(tag)


class _ViewFn(torch.autograd.Function):
    """The compute view of a block, its gradient delivered to ``sink``
    (a zero-stride tensor of the view's shape that requires grad): the
    gradient of a split forward with respect to each rank's view, which
    the trainer then sums into its blocks."""

    @staticmethod
    def forward(ctx, block, sink, make):
        out = make()
        return out.view_as(out) if out is block else out

    @staticmethod
    def backward(ctx, g):
        return None, g, None


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class MeshLeaf:
    """A leaf on a mesh as a split forward reads it: this rank's float32
    ``block`` (all layers of a stacked leaf), its ``placement``, whether
    the view is ``whole`` over ``"model"``, and the ``sink`` that receives
    the gradient of the view (:meth:`new` makes one)."""

    def __init__(self, block, sink, placement: Placement, mesh,
                 dtype: torch.dtype, whole: bool):
        self.block, self.sink, self.placement = block, sink, placement
        self.mesh, self.dtype, self.whole = mesh, dtype, whole

    @classmethod
    def new(cls, block, placement: Placement, mesh, dtype, whole: bool):
        sink = torch.zeros((), dtype=dtype, device=block.device).expand(
            view_shape(placement, mesh, whole)).requires_grad_(True)
        return cls(block, sink, placement, mesh, dtype, whole)

    def layers(self) -> list:
        """One leaf a layer of a stacked leaf (views of the block and the
        sink: the sink's gradient is their stack)."""
        pl = layer_placement(self.placement)
        return [MeshLeaf(b, s, pl, self.mesh, self.dtype, self.whole)
                for b, s in zip(self.block.unbind(0), self.sink.unbind(0))]

    def _make(self):
        return compute_view(self.block, self.placement, self.mesh,
                            self.dtype, self.whole)

    def view(self, tag):
        """The differentiable compute view.  A copy (gathered or cast) is
        counted under ``tag`` in :data:`GATHERED` while it lives, and
        :func:`keep_blocks` makes it again where a backward needs it."""
        out = _ViewFn.apply(self.block, self.sink, self._make)
        key = _storage(out)
        if key != _storage(self.block):
            _REMAKE[key] = self._make
            GATHERED.add(tag)
            weakref.finalize(out, _released, key, tag)
        return out


def leaf_view(t, tag):
    """``t`` itself, or the compute view of a :class:`MeshLeaf`."""
    return t.view(tag) if isinstance(t, MeshLeaf) else t


def materialize(tree, tag):
    return tree_map(lambda t: leaf_view(t, tag), tree)


def _pack(t: torch.Tensor):
    make = _REMAKE.get(_storage(t))
    if make is None:
        return t
    return make, t.size(), t.stride(), t.storage_offset()


def _unpack(saved):
    if isinstance(saved, torch.Tensor):
        return saved
    make, size, stride, offset = saved
    return make().as_strided(size, stride, offset)


def keep_blocks():
    """Saved-tensor hooks under which an autograd node that saves a view's
    copy keeps the recipe (the rank's block) instead, and gathers again in
    the backward: without remat, at most one layer's copy stays alive."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)

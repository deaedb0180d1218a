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
a time (:class:`MeshLeaf`): no caller gathers the whole tree.  The
backward hands each view's gradient to a :class:`GradReducer`, which
reduces a unit's views (a layer, the embedding, the head) as soon as the
backward has made all of their gradients, into the rank's float32
gradient blocks: no step holds the whole model's view gradients
(:data:`VIEW_GRADS`).
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.collectives import all_gather, psum_ordered, \
    shard_count, shard_index
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


class ViewGradLive:
    """The view-shaped gradient bytes that the reducer holds (handed over
    by the backward, not yet reduced), the most at once since
    :meth:`reset`, and the largest unit's views (their bytes in one
    micro-batch) for comparison."""

    def __init__(self):
        self.live = self.peak = self.largest_unit = 0

    def reset(self):
        self.peak, self.largest_unit = self.live, 0

    def add(self, nbytes: int):
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def drop(self, nbytes: int):
        self.live -= nbytes


VIEW_GRADS = ViewGradLive()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _packed_psum(items, mesh, axis: str) -> list:
    """``psum_ordered`` of several leaves' gradients ``items`` = [(leaf,
    g)] over ``axis`` in one call: flattened into one buffer, each rank's
    part cut to every leaf's block along ``axis`` (``take``), the sum
    unpacked into one tensor a leaf.  The sum of a packed buffer is the
    packing of the sums, bit for bit."""
    def cut(leaf, t):
        return axis_block(t, leaf.placement, mesh, axis)

    shapes = [cut(leaf, g).shape for leaf, g in items]
    sizes = [g.numel() for _, g in items]

    def take(buf):
        parts, at = [], 0
        for (leaf, g), n in zip(items, sizes):
            parts.append(cut(leaf, buf[at:at + n].view(g.shape)).reshape(-1))
            at += n
        return torch.cat(parts)

    flat = torch.cat([g.reshape(-1) for _, g in items]) if len(items) > 1 \
        else items[0][1].reshape(-1)
    summed = psum_ordered(flat, mesh, axis, take=take)
    out, at = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(summed[at:at + n].view(shape))
        at += n
    return out


class GradBlock:
    """A leaf's float32 gradient block on this rank (all layers of a
    stacked leaf), made when the backward first adds into it, so that it
    takes no memory before its first layer's gradient is made: a whole
    leaf's first gradient is kept as it comes (a reduce's result, a tensor
    of its own), a stacked leaf's block starts from zeros; ``t`` a tensor
    to add into instead (a gradient accumulated so far)."""

    def __init__(self, shape, device, t=None):
        self.shape, self.device, self.t = tuple(shape), device, t

    def add(self, x, index=None):
        if self.t is None and index is None:
            self.t = x
            return
        if self.t is None:
            self.t = torch.zeros(self.shape, dtype=torch.float32,
                                 device=self.device)
        (self.t if index is None else self.t[index]).add_(x)

    def value(self) -> torch.Tensor:
        """The gradient: zeros where nothing was added."""
        if self.t is None:
            self.t = torch.zeros(self.shape, dtype=torch.float32,
                                 device=self.device)
        return self.t


class GradReducer:
    """Reduces the gradients of a split forward's compute views into the
    rank's float32 gradient blocks (each :class:`MeshLeaf`'s
    :class:`GradBlock`) while the backward runs, a unit at a time: a
    partial gradient (``LeafPlan.partial``) summed over ``"model"`` in
    rank order and cut to the rank's ``"model"`` block, a whole one cut to
    it, then the float32 rank-ordered sum over ``"data"`` cut to the
    rank's block, added into the block.  A unit's leaves go in one packed
    buffer a mesh dim (one ``psum_ordered`` a unit and mesh dim).

    The forward names each view's unit (:meth:`expect`); a leaf belongs to
    the unit that viewed it first, and the views that a remat recompute
    makes again are not counted twice.  A leaf viewed more than once
    (a tied embedding, read by the embedding and the head) gets its views'
    gradients summed in the view's dtype, as autograd sums a tensor's uses,
    before the reduce.  :meth:`backward` runs the backward and then
    reduces any unit that the loss did not reach in full (in the order the
    forward viewed them), so every rank makes the same collectives."""

    def __init__(self, mesh, device):
        self.mesh = mesh
        # every view's input that requires grad: its outputs then do
        self.anchor = torch.zeros((), device=device, requires_grad=True)
        self.units: dict = {}       # tag -> leaves first viewed under it
        self.owner: dict = {}       # leaf -> its unit's tag
        self.left: dict = {}        # leaf -> view gradients still to come
        self.got: dict = {}         # leaf -> its views' gradients summed
        self.seen: set = set()      # (tag, leaf) viewed

    def expect(self, leaf, tag):
        if (tag, leaf) in self.seen:    # the recompute's view
            return
        self.seen.add((tag, leaf))
        if leaf not in self.owner:
            self.owner[leaf] = tag
            self.units.setdefault(tag, []).append(leaf)
        self.left[leaf] = self.left.get(leaf, 0) + 1

    def deliver(self, leaf, g):
        VIEW_GRADS.add(_nbytes(g))
        prev = self.got.get(leaf)
        if prev is not None:            # one tensor of the two
            g = prev + g
            VIEW_GRADS.drop(_nbytes(g))
        self.got[leaf] = g
        self.left[leaf] -= 1
        tag = self.owner[leaf]
        if all(self.left[lf] == 0 for lf in self.units[tag]):
            self._reduce(tag)

    def _reduce(self, tag):
        leaves = [lf for lf in self.units.pop(tag) if lf in self.got]
        items = [(lf, self.got.pop(lf)) for lf in leaves]
        held = sum(_nbytes(g) for _, g in items)
        VIEW_GRADS.largest_unit = max(VIEW_GRADS.largest_unit, held)
        if not items:
            return
        mesh = self.mesh
        items = [(lf, g.float()) for lf, g in items]
        partial = [i for i, (lf, _) in enumerate(items) if lf.plan.partial]
        if partial:
            summed = _packed_psum([items[i] for i in partial], mesh, "model")
            for i, t in zip(partial, summed):
                items[i] = (items[i][0], t)
        items = [(lf, axis_block(g, lf.placement, mesh, "model")
                  if lf.plan.whole and not lf.plan.partial else g)
                 for lf, g in items]
        for (lf, _), t in zip(items, _packed_psum(items, mesh, "data")):
            lf.grad.add(t, lf.index)
        VIEW_GRADS.drop(held)

    def backward(self, loss):
        """The backward of ``loss``, each unit reduced as its views'
        gradients are made, then the units it did not reach in full.  The
        leaves are let go after it: they hold the reducer, and a cycle
        would keep the step's gradient blocks alive until Python's cyclic
        collector ran (a gigabyte a step on the card)."""
        loss.backward()
        for tag in list(self.units):
            self._reduce(tag)
        for book in (self.units, self.owner, self.left, self.got, self.seen):
            book.clear()


class _ViewFn(torch.autograd.Function):
    """The compute view of a block; its gradient handed to the leaf's
    reducer (:meth:`GradReducer.deliver`) as the backward reaches it."""

    @staticmethod
    def forward(ctx, anchor, leaf, make):
        ctx.leaf = leaf
        out = make()
        return out.view_as(out) if out is leaf.block else out

    @staticmethod
    def backward(ctx, g):
        ctx.leaf.reducer.deliver(ctx.leaf, g)
        return None, None, None


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class MeshLeaf:
    """A leaf on a mesh as a split forward reads it: this rank's float32
    ``block`` (all layers of a stacked leaf), its ``placement``, the
    layer's ``plan`` for it (a ``LeafPlan``: the view whole over
    ``"model"`` or the rank's block, the gradient partial or not), the
    ``reducer`` that takes the view's gradient, and ``grad``, the
    :class:`GradBlock` that the reducer adds it into (at ``index``, the
    layer, for one layer of a stacked leaf)."""

    def __init__(self, block, placement: Placement, mesh, dtype: torch.dtype,
                 plan, reducer, grad, index=None):
        self.block, self.placement, self.mesh = block, placement, mesh
        self.dtype, self.plan, self.reducer = dtype, plan, reducer
        self.grad, self.index = grad, index

    def layers(self) -> list:
        """One leaf a layer of a stacked leaf (views of the block; each
        adds into its layer of the gradient block)."""
        pl = layer_placement(self.placement)
        return [MeshLeaf(b, pl, self.mesh, self.dtype, self.plan,
                         self.reducer, self.grad, i)
                for i, b in enumerate(self.block.unbind(0))]

    def _make(self):
        return compute_view(self.block, self.placement, self.mesh,
                            self.dtype, self.plan.whole)

    def view(self, tag):
        """The differentiable compute view, its unit ``tag`` told to the
        reducer.  A copy (gathered or cast) is counted under ``tag`` in
        :data:`GATHERED` while it lives, and :func:`keep_blocks` makes it
        again where a backward needs it."""
        self.reducer.expect(self, tag)
        out = _ViewFn.apply(self.reducer.anchor, self, self._make)
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

"""Tensor-parallel compute over a mesh's ``"model"`` dim: the port's
counterpart of what GSPMD inserts around the layers that the train rules
split (``heads``, ``kv_heads``, ``mlp``, ``vocab``, ``experts``,
``inner``, ``rglru_width`` -> ``"model"``).

Four autograd functions over the ``"model"`` group, on the collectives of
``sharding/collectives.py`` (each call recorded in ``COLLECTIVES`` and
``TRAFFIC``):

* :func:`copy_to_model` — a whole activation entering a split region:
  identity forward, rank-ordered sum of the ranks' partial gradients
  backward;
* :func:`reduce_from_model` — the ranks' partial sums leaving it:
  rank-ordered sum forward, identity backward;
* :func:`gather_from_model` — the ranks' slices concatenated along a dim:
  ``all_gather`` forward, this rank's slice of the gradient backward;
* :func:`scatter_to_model` — this rank's slice of a whole tensor: the
  slice forward, the ranks' slices gathered backward.

Where the rules map ``act_seq_sp`` onto ``"model"`` (the train rules, an
attention-only prefill under ``rules_for``), the residual that one
layer-pattern unit hands the next is the rank's range of the sequence
(:func:`residual_mode`): the unit gathers it over ``"model"`` when it
starts (:func:`gather_from_model` along the sequence dim) and keeps its
range of its output (:func:`scatter_to_model`), so the numbers are those
of the whole residual and remat saves S/T rows at each unit's edge.

Serving under the serve rules, the decode cache is split by sequence over
``"model"``: each rank attends over its range of every row's cache
(``decode_attention_partial``) and :func:`combine_partials` merges the
ranges' outputs by their log-sum-exps, in rank order.

Float sums over ranks go through ``psum_ordered``, never ``all_reduce``:
two runs of one world give the same bits.  A group of one returns its
input itself, in both directions.  With these the residual stream, the
loss and every gradient of a whole activation are the same on every
``"model"`` rank, so a leaf that every rank reads whole outside the split
regions gets the same gradient on every rank, and a leaf read whole inside
one gets a partial one (``LeafPlan.partial``) that the trainer sums over
``"model"``.

Each split layer decides its mode from the placements the rules give its
leaves (:func:`split_dims`) and returns it with a :class:`LeafPlan` a leaf
(a :class:`Plan`); its forward records the mode it ran in :data:`MODES`.
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.sharding.collectives import all_gather, psum_ordered, \
    shard_count, shard_index

MODEL = "model"
MODES: collections.Counter = collections.Counter()  # (layer kind, mode)


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How a layer reads one leaf on a mesh: ``whole``, gathered whole over
    ``"model"`` (else this rank's ``"model"`` block; a leaf that ``"model"``
    does not split is whole either way); ``partial``, its gradient on a
    rank is a partial sum over ``"model"`` (read whole inside a split
    region)."""
    whole: bool = True
    partial: bool = False


@dataclasses.dataclass(frozen=True)
class Plan:
    mode: str
    leaves: dict


def size(ctx) -> int:
    """The ``"model"`` size that a forward under ``ctx`` splits over: 1
    without a mesh and rules (one device), else the mesh's: a training
    forward under the train rules, or a prefill or decode step under the
    serve rules (weights the rank's blocks, the decode cache split by
    sequence)."""
    if ctx.mesh is None or ctx.rules is None or \
            MODEL not in (ctx.mesh.mesh_dim_names or ()):
        return 1
    return shard_count(ctx.mesh, MODEL)


def rules_size(rules) -> int:
    return 1 if rules is None else rules.mesh_sizes.get(MODEL, 1)


def split_dims(specs: dict, rules) -> dict:
    """{leaf name: the dim that ``"model"`` splits in its placement under
    ``rules``, or None} for a layer's (unstacked) spec dict."""
    out = {}
    for name, spec in specs.items():
        pl = rules.placement(spec.axes or (None,) * len(spec.shape),
                             spec.shape)
        dims = [d for d, axes in enumerate(pl.dims) if MODEL in axes]
        out[name] = dims[0] if dims else None
    return out


def plan_of(specs: dict, mode: str, blocks=(), partial=()) -> Plan:
    """A layer's plan: the leaves named in ``blocks`` read as this rank's
    ``"model"`` block, every other one whole; those in ``partial`` with
    partial gradients."""
    return Plan(mode, {name: LeafPlan(whole=name not in blocks,
                                      partial=name in partial)
                       for name in specs})


def whole_plan(specs: dict) -> Plan:
    return plan_of(specs, "whole")


def layer_mode(ctx, kind: str, plan_fn) -> str:
    """The mode a layer of ``kind`` runs under ``ctx``: ``"whole"`` where
    nothing splits over ``"model"``, else its plan's
    (``plan_fn(cfg, rules)``, made once a ``ctx``: ``Ctx.tp_modes``),
    recorded in :data:`MODES`."""
    if size(ctx) == 1:
        return "whole"
    mode = ctx.tp_modes.get(kind)
    if mode is None:
        mode = ctx.tp_modes[kind] = plan_fn(ctx.cfg, ctx.rules).mode
    MODES[(kind, mode)] += 1
    return mode


def residual_mode(ctx, shape) -> str:
    """How the residual ``(B, S, d)`` between two layer-pattern units lies
    on the ``"model"`` ranks: ``"seq"``, each rank its S/T range, where the
    rules map ``act_seq_sp`` onto ``"model"`` (T > 1 ranks) and T divides
    S (the reference's constraint on the carry, ``("batch", "act_seq_sp",
    "act_embed")``, fitted to the shape); else ``"whole"``."""
    if size(ctx) == 1:
        return "whole"
    dims = ctx.rules.placement(("batch", "act_seq_sp", "act_embed"),
                               tuple(shape)).dims
    return "seq" if MODEL in dims[1] else "whole"


def rank(mesh) -> int:
    return shard_index(mesh, MODEL)


def _slice(x, mesh, dim: int):
    n = x.shape[dim] // shard_count(mesh, MODEL)
    return x.narrow(dim, rank(mesh) * n, n).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum_ordered(g, ctx.mesh, MODEL), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return psum_ordered(x, mesh, MODEL)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(x, mesh, MODEL, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.mesh, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _slice(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, MODEL, dim=ctx.dim), None, None


def _one(mesh) -> bool:
    return shard_count(mesh, MODEL) == 1


def copy_to_model(x, mesh):
    return x if _one(mesh) else _Copy.apply(x, mesh)


def reduce_from_model(x, mesh):
    return x if _one(mesh) else _Reduce.apply(x, mesh)


def gather_from_model(x, mesh, dim: int = -1):
    return x if _one(mesh) else _Gather.apply(x, mesh, dim % x.dim())


def scatter_to_model(x, mesh, dim: int = -1):
    return x if _one(mesh) else _Scatter.apply(x, mesh, dim % x.dim())


def merge_partials(outs, lses):
    """The ranges' outputs (T, B, H, D) and log-sum-exps (T, B, H), in
    rank order, merged: lse* = max + log Σ_r exp(lse_r - max) and out =
    Σ_r exp(lse_r - lse*) · out_r, summed in rank order.  Empty ranges
    (lse -inf) weigh nothing; a row whose ranges are all empty gives out 0
    and lse* -inf, no NaN.  Returns (out, lse*)."""
    top = lses.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, 0.0)
    total = torch.zeros_like(top)
    for r in range(lses.shape[0]):
        total = total + torch.exp(lses[r] - top)
    lse = top + torch.log(total)
    out = torch.zeros_like(outs[0])
    for r in range(lses.shape[0]):
        w = torch.where(lses[r] == -torch.inf, 0.0, torch.exp(lses[r] - lse))
        out = out + w[..., None] * outs[r]
    return out, lse


def combine_partials(out, lse, mesh):
    """Merge the ranges of a cache split by sequence over ``"model"``:
    ``out`` (B, H, D) float32 this rank's normalised output over its range
    and ``lse`` (B, H) its log-sum-exp (-inf for an empty range), as
    ``decode_attention_partial`` returns them.  One ``all_gather`` of
    (B, H, D + 1) floats, then :func:`merge_partials` in rank order: the
    same bits on every rank.  Returns (out, lse*)."""
    both = torch.cat([out, lse[..., None]], dim=-1)[None]
    if not _one(mesh):
        both = all_gather(both, mesh, MODEL, dim=0)     # (T, B, H, D + 1)
    return merge_partials(both[..., :-1], both[..., -1])

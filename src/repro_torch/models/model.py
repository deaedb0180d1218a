"""Top-level decoder: port of ``repro/models/model.py`` (segments, spec
trees, ``forward``, the training loss ``loss_fn`` with its fused lm-head
cross-entropy ``chunked_ce_loss``, ``logits_last``, ``prefill``,
``decode_step``).

Layers are grouped into segments as in the reference (the repeating
``layer_pattern`` unit stacked ``n`` times, leaves with a leading layer
axis); where the reference scans a segment with ``lax.scan``, the port runs
a Python loop over the stacked layers, each leaf split into its layers by
``unbind`` (views, no copy).  In ``train`` mode with ``cfg.remat`` each unit runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are recomputed
in the backward, the reference's ``jax.checkpoint(nothing_saveable)``.

Serving on a mesh (the prefill and decode steps under the serve rules,
``launch/steps.py``): the leaves are the rank's blocks
(:func:`serve_params`), each layer splits over ``"model"`` as in
training, the cache is the rank's block (:func:`cache_placements`; its
``"cache_len"`` entry the whole attention cache's length) and the logits
are gathered over the vocab split.

Training on a mesh (``Ctx.rules``; the leaves
:class:`~repro_torch.models.params.MeshLeaf` objects): each unit gathers its
layer's weights over ``"data"`` (and the leaves its plan reads whole over
``"model"``) just before it runs, in the compute dtype.  Under remat the
gather runs again in the recompute; without it the autograd nodes keep the
rank's blocks and gather again in the backward (``keep_blocks``).  Either
way at most one layer's gathered copy is alive at a time, as in the
reference's scan.  Each layer splits its products over ``"model"``
(:func:`model_plan`), and so does the cross-entropy: vocab-parallel, each
chunk's local logits reduced by a max over ``"model"`` (exact), a
rank-ordered sum of ``exp`` and the label logit from the rank that owns
it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.blocks import (
    attn_cache_len,
    block_apply,
    block_cache_specs,
    block_specs,
    block_tp,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Ctx,
    embed_specs,
    embed_tokens,
    embed_tp,
    output_weights,
    rmsnorm,
    rmsnorm_specs,
)
from repro_torch.models.params import (
    MeshLeaf,
    ParamSpec,
    keep_blocks,
    leaf_dtype,
    materialize,
    shard_leaf,
    shardings,
    tree_leaves,
    tree_map,
)
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.collectives import pmax, psum_ordered


def check_supported(cfg: ModelConfig) -> None:
    """Raise on block kinds the reference does not have.  Attention,
    RG-LRU and Mamba SSM blocks, in any layer pattern, with dense or MoE
    MLPs, RoPE or M-RoPE, and token or embedding inputs, are ported."""
    unknown = set(cfg.layer_kinds()) - {"attn", "rglru", "ssm"}
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {sorted(unknown)}")


def build_segments(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    pattern = tuple(cfg.layer_pattern)
    full, rem = divmod(cfg.num_layers, len(pattern))
    segs = []
    if full:
        segs.append((pattern, full))
    if rem:
        segs.append((pattern[:rem], 1))
    return segs


def _stack_specs(specs: dict, n: int) -> dict:
    return tree_map(lambda s: dataclasses.replace(
        s, shape=(n,) + s.shape,
        axes=("layers",) + s.axes if s.axes else ()), specs)


def model_specs(cfg: ModelConfig, serve: bool = False) -> dict:
    """``serve``: the serve-time specs (int8 experts where
    ``cfg.quant_experts_serve``)."""
    check_supported(cfg)
    segments = [{f"pos{i}": _stack_specs(block_specs(cfg, kind, serve=serve),
                                         n)
                 for i, kind in enumerate(pattern)}
                for pattern, n in build_segments(cfg)]
    return {"embed": embed_specs(cfg), "segments": segments,
            "final_norm": rmsnorm_specs(cfg.d_model)}


def model_plan(cfg: ModelConfig, rules, serve: bool = False) -> dict:
    """Each leaf's :class:`~repro_torch.sharding.tensor_parallel.LeafPlan`
    under ``rules`` (the tree of :func:`model_specs` of ``serve``; a
    stacked leaf's plan is its layers')."""
    return {"embed": embed_tp(cfg, rules).leaves,
            "segments": [{f"pos{i}": block_tp(cfg, kind, rules, serve)
                          for i, kind in enumerate(pattern)}
                         for pattern, _ in build_segments(cfg)],
            "final_norm": {"scale": tp.LeafPlan()}}


def serve_params(cfg: ModelConfig, params, rules, mesh=None) -> dict:
    """This rank's serve weights from a whole serve parameter tree (of
    :func:`model_specs` ``(cfg, serve=True)``, e.g. from
    ``convert.model_params_from_numpy(..., serve=True)``): each leaf its
    ``"model"`` block under the serve placements (``params.shard_leaf``)
    where the layer's plan reads the block, whole where it reads the leaf
    whole (``kv_whole``'s ``wk``/``wv``, Mamba's ``in_proj``, the norms,
    every leaf of a layer that runs whole).  Under the serve rules no
    weight is split over ``"data"``: nothing is gathered."""
    mesh = mesh if mesh is not None else rules.mesh

    def leaf(pl, plan, t):
        if plan.whole:
            return t
        if set(pl.split_axes) - {tp.MODEL}:
            raise ValueError(f"a serve weight of {pl.shape} split over "
                             f"{pl.dims}: only \"model\" splits weights")
        return shard_leaf(t, pl, mesh)

    specs = model_specs(cfg, serve=True)
    return tree_map(leaf, shardings(specs, mesh, rules),
                    model_plan(cfg, rules, serve=True), params)


def cache_placements(cfg: ModelConfig, rules, batch: int, seq_len: int):
    """Each leaf's placement in the whole cache of :func:`cache_specs`
    under the serve rules: the rows over ``"data"``, the K/V by sequence
    over ``"model"`` where it divides the cache length, the recurrent
    states by channel."""
    return shardings(cache_specs(cfg, batch, seq_len), None, rules)


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    check_supported(cfg)
    segments = [{f"pos{i}": _stack_specs(
        block_cache_specs(cfg, kind, batch, seq_len), n)
        for i, kind in enumerate(pattern)}
        for pattern, n in build_segments(cfg)]
    return {"length": ParamSpec((), dtype="int32", init="zeros"),
            "segments": segments}


def _layer(tree, i: int):
    return tree_map(lambda t: t[i], tree)


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked parameter tree, one ``unbind`` a leaf:
    views, whose backward is one ``stack`` a leaf (``n`` indexings would
    each scatter their gradient into a zero tensor of the stacked size);
    a :class:`MeshLeaf` into its layers' (ungathered)."""
    parts = [t.layers() if isinstance(t, MeshLeaf) else t.unbind(0)
             for t in tree_leaves(tree)]
    layers = []
    for i in range(n):
        it = iter([p[i] for p in parts])
        layers.append(tree_map(lambda _: next(it), tree))
    return layers


def _default_positions(cfg: ModelConfig, mode: str, length, b: int, s: int,
                       device):
    """The reference's positions when the caller passes none: the slab's
    per-row (or the cache's) ``length`` on a decode step, ``arange(S)`` on
    a prefill; for M-RoPE the same broadcast to (B, 3, ·)."""
    if mode == "decode":
        pos = length.reshape(1, 1) if length.dim() == 0 else length[:, None]
        positions = torch.broadcast_to(pos, (b, 1)).to(torch.int32)
    else:
        positions = torch.broadcast_to(
            torch.arange(s, dtype=torch.int32, device=device)[None], (b, s))
    if cfg.mrope:
        positions = torch.broadcast_to(positions[:, None, :],
                                       (b, 3, positions.shape[1]))
    return positions


def _unit(ctx: Ctx, pattern, layer_p, x, positions, length, layer_c,
          emit_cache: bool, given: bool, tag=None):
    """One repeat of the layer pattern -> (x, its new caches, summed aux).
    Mesh leaves are gathered here (under ``tag``), inside the unit."""
    layer_p = materialize(layer_p, tag)
    new_c, aux = {}, 0.0
    for j, kind in enumerate(pattern):
        key = f"pos{j}"
        x, nc, a = block_apply(
            ctx, kind, layer_p[key], x, positions=positions, length=length,
            cache=layer_c[key] if layer_c is not None else None,
            emit_cache=emit_cache, positions_given=given)
        if nc is not None:
            new_c[key] = nc
        aux = aux + a
    return x, new_c, aux


def forward(ctx: Ctx, params: dict, inputs: dict, *,
            cache: Optional[dict] = None, emit_cache: bool = False):
    """inputs: {"tokens": (B, S)} or {"embeddings": (B, S, d)} (configs
    with ``embed_inputs=False``); optional {"positions": (B, S), or
    (B, 3, S) for M-RoPE}.  Returns (hidden (B, S, d), new_cache, aux):
    ``aux`` the MoE load-balancing losses summed over the layers (a float32
    0-d tensor; the Python float 0.0 for a model without MoE).

    Decode (``cache`` given): the cache's leaves (K/V, convolution and
    recurrent states) are updated in place and returned under the new
    ``length`` (scalar or per-row (B,))."""
    cfg = ctx.cfg
    if cfg.embed_inputs:
        tokens = inputs["tokens"]
        x = embed_tokens(ctx, params["embed"], tokens)
        if cfg.family == "hybrid":      # gemma-style embedding scale
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
    else:
        x = inputs["embeddings"].to(ctx.compute_dtype)
    b, s = x.shape[0], x.shape[1]
    length = cache["length"] if cache is not None else None
    split = tp.size(ctx) > 1 and ctx.mode != "train"
    if split:     # the whole attention cache that the rank's blocks are of
        total = (cache.get("cache_len") if cache is not None
                 else attn_cache_len(cfg, s))
        # split by sequence unless fitted_spec drops the axis (T ∤ C); no
        # length without attention layers
        ctx = dataclasses.replace(
            ctx, cache_len=total, cache_split=total is not None
            and tp.MODEL in ctx.rules.placement(("cache_seq",),
                                                (total,)).dims[0])
    given = "positions" in inputs
    positions = inputs["positions"] if given else _default_positions(
        cfg, ctx.mode, length, b, s, x.device)
    remat = cfg.remat and ctx.mode == "train"
    on_mesh = isinstance(params["final_norm"]["scale"], MeshLeaf)

    new_segments, aux_total = [], 0.0
    for seg_idx, (pattern, n) in enumerate(build_segments(cfg)):
        seg_params = params["segments"][seg_idx]
        seg_cache = cache["segments"][seg_idx] if cache is not None else None
        emitted = []
        for i, layer_p in enumerate(_unstack(seg_params, n)):
            args = (ctx, pattern, layer_p, x, positions,
                    length, _layer(seg_cache, i) if seg_cache is not None
                    else None, emit_cache, given, (seg_idx, i))
            if remat:
                x, new_c, aux = checkpoint(_unit, *args, use_reentrant=False)
            else:
                with keep_blocks() if on_mesh else contextlib.nullcontext():
                    x, new_c, aux = _unit(*args)
            aux_total = aux_total + aux
            emitted.append(new_c)
        if seg_cache is not None:
            new_segments.append(seg_cache)       # written in place
        elif emitted[0]:
            new_segments.append(tree_map(lambda *ls: torch.stack(ls),
                                         emitted[0], *emitted[1:]))
        else:
            new_segments.append(None)

    x = rmsnorm(materialize(params["final_norm"], "final_norm"), x,
                cfg.norm_eps)
    new_cache = None
    if any(sg is not None for sg in new_segments):
        new_len = length + s if length is not None else torch.tensor(
            s, dtype=torch.int32, device=x.device)
        new_cache = {"length": new_len, "segments": new_segments}
        if split and "attn" in cfg.layer_kinds():
            new_cache["cache_len"] = ctx.cache_len
    return x, new_cache, aux_total


def _ce_chunk(x_blk, w, l_blk, m_blk):
    """Summed masked negative log-likelihood of one sequence chunk."""
    logits = (x_blk @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, l_blk[..., None].long())[..., 0]
    return ((lse - tgt) * m_blk).sum()


def _ce_chunk_split(x_blk, w, l_blk, m_blk, mesh):
    """:func:`_ce_chunk` with the head's columns (``w``) this rank's vocab
    range: the max over ``"model"`` (exact), the rank-ordered sum of the
    ranks' sums of ``exp``, the label logit from the rank that owns it.
    The same on every ``"model"`` rank."""
    logits = (tp.copy_to_model(x_blk, mesh) @ w).float()     # (B, c, V/T)
    m = pmax(logits.detach().amax(dim=-1), mesh, tp.MODEL)
    total = tp.reduce_from_model(torch.exp(logits - m[..., None]).sum(dim=-1),
                                 mesh)
    lse = torch.log(total) + m
    n = logits.shape[-1]
    local = l_blk.long() - tp.rank(mesh) * n
    inside = (local >= 0) & (local < n)
    tgt = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    tgt = tp.reduce_from_model(torch.where(inside, tgt, 0.0), mesh)
    return ((lse - tgt) * m_blk).sum()


def chunked_ce_loss(ctx: Ctx, x, w_out, labels, mask=None):
    """Fused lm-head + cross-entropy over sequence chunks of
    ``cfg.loss_chunk`` (the reference's scan): each chunk's logits (B,
    chunk, V), the product in the compute dtype then float32, live only
    inside its chunk and are recomputed in the backward
    (``torch.utils.checkpoint``), never saved.  Returns the masked mean
    over the tokens (float32 0-d); with ``ctx.mesh``, this rank's masked
    sum over the mask count summed over ``"data"`` (its share of the
    global mean).  Split over ``"model"`` by vocab (``w_out`` this rank's
    columns), each chunk is :func:`_ce_chunk_split`."""
    b, s, _ = x.shape
    chunk = min(ctx.cfg.loss_chunk, s)
    if s % chunk:
        raise ValueError(f"chunked_ce_loss: sequence {s} is not a multiple "
                         f"of the loss chunk {chunk}")
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    w = w_out.to(ctx.compute_dtype)
    split = tp.layer_mode(ctx, "head", embed_tp) == "vocab"
    fn, more = (_ce_chunk_split, (ctx.mesh,)) if split else (_ce_chunk, ())
    total = denom = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        m_blk = mask[:, sl].float()
        total = total + checkpoint(fn, x[:, sl], w, labels[:, sl], m_blk,
                                   *more, use_reentrant=False)
        denom = denom + m_blk.sum()
    if ctx.mesh is not None:
        denom = psum_ordered(denom, ctx.mesh, "data")
    return total / torch.clamp_min(denom, 1.0)


def logits_last(ctx: Ctx, x_last, w_out):
    """x_last: (B, 1, d) -> (B, V) float32 logits (the product in the
    compute dtype, as the reference's einsum).  Under the serve rules with
    the head split by vocab (``w_out`` the rank's columns) the ranks'
    logits are gathered over ``"model"`` in rank order: whole on every
    rank."""
    logits = (x_last @ w_out)[:, 0].float()
    if tp.layer_mode(ctx, "head", embed_tp) == "vocab":
        logits = tp.gather_from_model(logits, ctx.mesh, dim=-1)
    return logits


def compute_params(cfg: ModelConfig, params):
    """Each leaf in the dtype the forward reads it in: its spec's own dtype
    (float32 norm scales and SSM/RG-LRU gates), else the compute dtype.
    Differentiable: float32 master weights of a bf16 model cast here, once
    a step, as the reference casts each weight inside its products
    (``.astype(dt)``); leaves already in their dtype are not copied."""
    dt = getattr(torch, cfg.compute_dtype)
    return tree_map(lambda spec, t: t if isinstance(t, MeshLeaf) else
                    t.to(leaf_dtype(spec, dt)), model_specs(cfg), params)


def loss_fn(ctx: Ctx, params, batch, aux_weight: float = 0.01):
    """Training loss -> (ce + aux_weight · aux, {"ce", "aux"}): ``batch``
    holds the model inputs of :func:`forward`, ``labels`` (B, S) and an
    optional float ``mask`` (B, S); ``params`` in any float dtype (float32
    masters train a bf16 model: :func:`compute_params`).  With
    ``ctx.mesh``, the three are this rank's shares: their sums over
    ``"data"`` are the global batch's values.  ``params`` may be
    :class:`MeshLeaf` leaves (the trainer on a mesh), each gathered where it
    is read."""
    params = compute_params(ctx.cfg, params)
    x, _, aux = forward(ctx, params, batch)
    w_out = output_weights(ctx.cfg, params["embed"])
    ce = chunked_ce_loss(ctx, x, w_out, batch["labels"], batch.get("mask"))
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def prefill(ctx: Ctx, params, batch):
    ctx = dataclasses.replace(ctx, mode="prefill")
    x, cache, _ = forward(ctx, params, batch, emit_cache=True)
    w_out = output_weights(ctx.cfg, params["embed"])
    return logits_last(ctx, x[:, -1:], w_out), cache


def decode_step(ctx: Ctx, params, cache, batch):
    ctx = dataclasses.replace(ctx, mode="decode")
    x, new_cache, _ = forward(ctx, params, batch, cache=cache)
    w_out = output_weights(ctx.cfg, params["embed"])
    return logits_last(ctx, x, w_out), new_cache

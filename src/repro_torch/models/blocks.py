"""Decoder blocks: port of ``repro/models/blocks.py`` — a pre-norm mixer
(attention, RG-LRU or Mamba SSM) and, after attention and RG-LRU mixers, a
pre-norm gated MLP: dense, or the MoE of ``models/moe.py`` when the config
has one (SSM blocks are mixer-only).

Split over ``"model"`` (:func:`block_tp`), each mixer and MLP splits its
own products and sums them over ``"model"`` before the residual add: the
residual stream and the norms are whole on every ``"model"`` rank inside a
block.  Between layer-pattern units the residual may be the rank's range
of the sequence (``act_seq_sp``, ``models/model.py`` ``_unit``), gathered
whole before the unit's first block.  Under the serve rules the same split
runs on the rank's blocks, and each cache leaf is the rank's block of the
whole one (:func:`~repro_torch.models.model.cache_placements`): the K/V
by sequence, the recurrent states by channel."""
from __future__ import annotations

from typing import Optional

from repro_torch.models.attention import attn_forward, attn_specs, attn_tp
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx, rmsnorm, rmsnorm_specs
from repro_torch.models.mlp import mlp_forward, mlp_specs, mlp_tp
from repro_torch.models.moe import moe_forward, moe_specs, moe_tp
from repro_torch.models.params import ParamSpec
from repro_torch.models.rglru import rglru_forward, rglru_specs, rglru_tp
from repro_torch.models.ssm import ssm_forward, ssm_specs, ssm_tp
from repro_torch.sharding import tensor_parallel as tp

_MIXERS = {"attn": attn_specs, "rglru": rglru_specs, "ssm": ssm_specs}
_MIXER_TP = {"attn": attn_tp, "rglru": rglru_tp, "ssm": ssm_tp}


def _check(kind: str) -> None:
    if kind not in _MIXERS:
        raise ValueError(f"unknown block kind {kind!r}")


def block_specs(cfg: ModelConfig, kind: str, serve: bool = False) -> dict:
    """``serve``: int8 expert weights where ``cfg.quant_experts_serve``."""
    _check(kind)
    specs = {"norm1": rmsnorm_specs(cfg.d_model), kind: _MIXERS[kind](cfg)}
    if kind != "ssm":
        specs["norm2"] = rmsnorm_specs(cfg.d_model)
        specs["mlp"] = (moe_specs(cfg, quantized=serve
                                  and cfg.quant_experts_serve)
                        if cfg.moe is not None else mlp_specs(cfg))
    return specs


def block_tp(cfg: ModelConfig, kind: str, rules, serve: bool = False
             ) -> dict:
    """Each leaf's :class:`~repro_torch.sharding.tensor_parallel.LeafPlan`
    in a block of ``kind`` under ``rules`` (the tree of
    :func:`block_specs`; ``serve``: of the serve-time specs)."""
    whole = tp.LeafPlan()
    out = {"norm1": {"scale": whole},
           kind: _MIXER_TP[kind](cfg, rules).leaves}
    if kind != "ssm":
        out["norm2"] = {"scale": whole}
        out["mlp"] = (moe_tp(cfg, rules, serve and cfg.quant_experts_serve)
                      if cfg.moe is not None else mlp_tp(cfg, rules)).leaves
    return out


def attn_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.attn_window is not None:
        return min(cfg.attn_window, seq_len)    # rolling window cache
    return seq_len + cfg.decode_headroom


def block_cache_specs(cfg: ModelConfig, kind: str, batch: int,
                      seq_len: int) -> dict:
    """Per-layer cache: K/V for attention (compute dtype); the convolution
    state (compute dtype) and the float32 recurrent state ``h`` for the
    RG-LRU and SSM mixers."""
    _check(kind)
    dt = cfg.compute_dtype
    if kind == "attn":
        shape = (batch, attn_cache_len(cfg, seq_len), cfg.num_kv_heads,
                 cfg.head_dim)
        axes = ("cache_batch", "cache_seq", "cache_kv", "cache_dim")
        return {"k": ParamSpec(shape, axes=axes, dtype=dt, init="zeros"),
                "v": ParamSpec(shape, axes=axes, dtype=dt, init="zeros")}
    if kind == "ssm":
        width, cw, wax = cfg.d_inner, cfg.ssm.d_conv, "inner"
        h = (batch, width, cfg.ssm.d_state)
        h_axes = ("cache_batch", wax, "state")
    else:
        width, cw, wax = cfg.lru_width, cfg.rglru.conv_width, "rglru_width"
        h = (batch, width)
        h_axes = ("cache_batch", wax)
    return {"conv": ParamSpec((batch, cw - 1, width),
                              axes=("cache_batch", None, wax), dtype=dt,
                              init="zeros"),
            "h": ParamSpec(h, axes=h_axes, dtype="float32", init="zeros")}


def block_apply(ctx: Ctx, kind: str, p: dict, x, *, positions, length=None,
                cache: Optional[dict] = None, emit_cache: bool = False,
                positions_given: bool = False):
    """Returns (x, new_cache or None, aux): ``aux`` is the MoE block's
    load-balancing loss (a float32 0-d tensor), the Python float 0.0 for
    every other block (no tensor made on the serving path).  The block kind
    was checked when the specs were built.  ``positions_given``: the caller
    passed ``positions`` (the prefill kernel masks by them)."""
    cfg = ctx.cfg
    aux = 0.0
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        c = dict(cache, length=length) if cache is not None else None
        out_len = attn_cache_len(cfg, x.shape[1]) if emit_cache else None
        y, new_cache = attn_forward(ctx, p["attn"], h, positions=positions,
                                    cache=c, cache_out_len=out_len,
                                    positions_given=positions_given)
        if new_cache is not None:
            new_cache.pop("length", None)
    else:
        mixer = rglru_forward if kind == "rglru" else ssm_forward
        y, new_cache = mixer(ctx, p[kind], h, cache=cache,
                             emit_cache=emit_cache)
    x = x + y
    if kind != "ssm":
        h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
        if cfg.moe is not None:
            y2, aux = moe_forward(ctx, p["mlp"], h2)
        else:
            y2 = mlp_forward(ctx, p["mlp"], h2, activation=cfg.mlp_activation)
        x = x + y2
    return x, new_cache, aux

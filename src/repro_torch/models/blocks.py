"""Decoder blocks: port of ``repro/models/blocks.py`` — a pre-norm mixer
(attention, RG-LRU or Mamba SSM) and, after attention and RG-LRU mixers, a
pre-norm dense gated MLP (SSM blocks are mixer-only).  The MoE MLP is
ROADMAP queue A.14."""
from __future__ import annotations

from typing import Optional

from repro_torch.models.attention import attn_forward, attn_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx, rmsnorm, rmsnorm_specs
from repro_torch.models.mlp import mlp_forward, mlp_specs
from repro_torch.models.params import ParamSpec
from repro_torch.models.rglru import rglru_forward, rglru_specs
from repro_torch.models.ssm import ssm_forward, ssm_specs

_MIXERS = {"attn": attn_specs, "rglru": rglru_specs, "ssm": ssm_specs}


def _check(cfg: ModelConfig, kind: str) -> None:
    if kind not in _MIXERS:
        raise ValueError(f"unknown block kind {kind!r}")
    if cfg.moe is not None:
        raise NotImplementedError("MoE MLPs are ROADMAP queue A.14")


def block_specs(cfg: ModelConfig, kind: str) -> dict:
    _check(cfg, kind)
    specs = {"norm1": rmsnorm_specs(cfg.d_model), kind: _MIXERS[kind](cfg)}
    if kind != "ssm":
        specs["norm2"] = rmsnorm_specs(cfg.d_model)
        specs["mlp"] = mlp_specs(cfg)
    return specs


def attn_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.attn_window is not None:
        return min(cfg.attn_window, seq_len)    # rolling window cache
    return seq_len + cfg.decode_headroom


def block_cache_specs(cfg: ModelConfig, kind: str, batch: int,
                      seq_len: int) -> dict:
    """Per-layer cache: K/V for attention (compute dtype); the convolution
    state (compute dtype) and the float32 recurrent state ``h`` for the
    RG-LRU and SSM mixers."""
    _check(cfg, kind)
    dt = cfg.compute_dtype
    if kind == "attn":
        shape = (batch, attn_cache_len(cfg, seq_len), cfg.num_kv_heads,
                 cfg.head_dim)
        return {"k": ParamSpec(shape, dtype=dt, init="zeros"),
                "v": ParamSpec(shape, dtype=dt, init="zeros")}
    if kind == "ssm":
        width, cw = cfg.d_inner, cfg.ssm.d_conv
        h = (batch, width, cfg.ssm.d_state)
    else:
        width, cw = cfg.lru_width, cfg.rglru.conv_width
        h = (batch, width)
    return {"conv": ParamSpec((batch, cw - 1, width), dtype=dt, init="zeros"),
            "h": ParamSpec(h, dtype="float32", init="zeros")}


def block_apply(ctx: Ctx, kind: str, p: dict, x, *, positions, length=None,
                cache: Optional[dict] = None, emit_cache: bool = False):
    """Returns (x, new_cache or None); the reference's third output, the
    MoE auxiliary loss, is zero for a dense MLP and is not carried.  The
    block kind was checked when the specs were built."""
    cfg = ctx.cfg
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        c = dict(cache, length=length) if cache is not None else None
        out_len = attn_cache_len(cfg, x.shape[1]) if emit_cache else None
        y, new_cache = attn_forward(ctx, p["attn"], h, positions=positions,
                                    cache=c, cache_out_len=out_len)
        if new_cache is not None:
            new_cache.pop("length", None)
    else:
        mixer = rglru_forward if kind == "rglru" else ssm_forward
        y, new_cache = mixer(ctx, p[kind], h, cache=cache,
                             emit_cache=emit_cache)
    x = x + y
    if kind != "ssm":
        h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + mlp_forward(ctx, p["mlp"], h2, activation=cfg.mlp_activation)
    return x, new_cache

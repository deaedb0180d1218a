"""Decoder blocks: port of the attention block of ``repro/models/blocks.py``
(pre-norm attention + pre-norm dense gated MLP).  The RG-LRU and SSM mixers
and the MoE MLP are ROADMAP queue A.14."""
from __future__ import annotations

from typing import Optional

from repro_torch.models.attention import attn_forward, attn_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx, rmsnorm, rmsnorm_specs
from repro_torch.models.mlp import mlp_forward, mlp_specs
from repro_torch.models.params import ParamSpec


def _only_attn(cfg: ModelConfig, kind: str) -> None:
    if kind != "attn":
        raise NotImplementedError(f"{kind!r} blocks are ROADMAP queue A.14")
    if cfg.moe is not None:
        raise NotImplementedError("MoE MLPs are ROADMAP queue A.14")


def block_specs(cfg: ModelConfig, kind: str) -> dict:
    _only_attn(cfg, kind)
    return {"norm1": rmsnorm_specs(cfg.d_model), "attn": attn_specs(cfg),
            "norm2": rmsnorm_specs(cfg.d_model), "mlp": mlp_specs(cfg)}


def attn_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.attn_window is not None:
        return min(cfg.attn_window, seq_len)    # rolling window cache
    return seq_len + cfg.decode_headroom


def block_cache_specs(cfg: ModelConfig, kind: str, batch: int,
                      seq_len: int) -> dict:
    _only_attn(cfg, kind)
    c = attn_cache_len(cfg, seq_len)
    shape = (batch, c, cfg.num_kv_heads, cfg.head_dim)
    return {"k": ParamSpec(shape, dtype=cfg.compute_dtype, init="zeros"),
            "v": ParamSpec(shape, dtype=cfg.compute_dtype, init="zeros")}


def block_apply(ctx: Ctx, kind: str, p: dict, x, *, positions, length=None,
                cache: Optional[dict] = None, emit_cache: bool = False):
    """Returns (x, new_cache or None); the reference's third output, the
    MoE auxiliary loss, is zero for a dense MLP and is not carried.  The
    block kind was checked when the specs were built."""
    cfg = ctx.cfg
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    c = dict(cache, length=length) if cache is not None else None
    out_len = attn_cache_len(cfg, x.shape[1]) if emit_cache else None
    y, new_cache = attn_forward(ctx, p["attn"], h, positions=positions,
                                cache=c, cache_out_len=out_len)
    if new_cache is not None:
        new_cache.pop("length", None)
    x = x + y
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    x = x + mlp_forward(ctx, p["mlp"], h2, activation=cfg.mlp_activation)
    return x, new_cache

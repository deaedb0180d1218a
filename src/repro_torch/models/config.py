"""Model configuration dataclasses: a copy of ``repro/models/config.py``.

The port reads the attention (RoPE and M-RoPE), MLP, MoE, SSM, RG-LRU,
embedding, cache and numerics fields, and the per-mode sharding rule
overrides (``sharding_overrides``, read by ``sharding.rules.make_rules``
through the trainer and the training launcher).  The reference's Pallas
switch has no counterpart: the port's kernels are pinned per call with
``force=``."""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    min_capacity: int = 16


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 mixer."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> d_model // 16


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU recurrent mixer (RecurrentGemma / Griffin)."""
    lru_width: int = 0  # 0 -> d_model
    conv_width: int = 4
    block_width: int = 256  # temporal chunk for the blocked scan


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    attn_window: Optional[int] = None     # None = full causal; int = sliding window
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False                    # qwen2-vl multimodal rope
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    # layer mixture; pattern repeats over layers: entries in {attn, rglru, ssm}
    layer_pattern: tuple[str, ...] = ("attn",)
    # sub-modules
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # embeddings
    embed_inputs: bool = True              # False: frontend stub feeds embeddings
    tie_embeddings: bool = False
    mlp_activation: str = "silu"           # silu | gelu (recurrentgemma GeGLU)
    # full-attention caches reserve this many decode slots past the prompt
    # (without it the first decoded token wraps to slot 0 and overwrites the
    # first prompt token — found by the prefill/decode consistency tests)
    decode_headroom: int = 64
    # numerics / compilation
    norm_eps: float = 1e-6
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"           # serve paths cast to compute dtype
    scan_layers: bool = True
    remat: bool = True
    attn_chunk: int = 1024                 # kv-chunk for memory-efficient attention
    loss_chunk: int = 512                  # seq-chunk for the fused lm-head/CE loss
    # per-mode sharding rule overrides: {"train": {...}, "serve": {...}}
    sharding_overrides: Mapping[str, Mapping[str, object]] = dataclasses.field(
        default_factory=dict
    )
    # int8 expert weights at serve time (mixtral-class models whose bf16
    # experts alone exceed 16 GB/chip under 16-way TP; also halves the
    # weight-streaming memory term of MoE decode)
    quant_experts_serve: bool = False

    # ------------------------------------------------------------------
    @property
    def dt_rank(self) -> int:
        if self.ssm is None:
            return 0
        return self.ssm.dt_rank or max(1, self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def lru_width(self) -> int:
        if self.rglru is None:
            return 0
        return self.rglru.lru_width or self.d_model

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def layer_kinds(self) -> tuple[str, ...]:
        return tuple(self.layer_kind(i) for i in range(self.num_layers))

    @property
    def uniform_layers(self) -> bool:
        return len(set(self.layer_kinds())) == 1

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state does not grow linearly with full context."""
        kinds = set(self.layer_kinds())
        if kinds <= {"ssm", "rglru"}:
            return True
        # attention layers are sub-quadratic iff windowed
        return self.attn_window is not None

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (matches the built spec tree)."""
        n = 0
        if self.embed_inputs:
            n += self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for kind in self.layer_kinds():
            n += self.d_model  # pre-mixer norm
            if kind == "attn":
                qkv = self.d_model * self.head_dim * (self.num_heads + 2 * self.num_kv_heads)
                o = self.num_heads * self.head_dim * self.d_model
                n += qkv + o
                if self.qkv_bias:
                    n += self.head_dim * (self.num_heads + 2 * self.num_kv_heads)
                if self.qk_norm:
                    n += 2 * self.head_dim
            elif kind == "ssm":
                d_in, r, s = self.d_inner, self.dt_rank, self.ssm.d_state
                n += self.d_model * 2 * d_in            # in_proj
                n += self.ssm.d_conv * d_in + d_in      # conv w + b
                n += d_in * (r + 2 * s)                 # x_proj
                n += r * d_in + d_in                    # dt_proj
                n += d_in * s + d_in                    # A_log, D
                n += d_in * self.d_model                # out_proj
            elif kind == "rglru":
                w = self.lru_width
                n += self.d_model * w * 2               # branch projections
                n += self.rglru.conv_width * w + w      # temporal conv w + b
                n += 2 * (w * w + w)                    # recurrence/input gates
                n += w                                  # Lambda param
                n += w * self.d_model                   # out proj
            if kind == "attn" or kind == "rglru":
                # MLP follows attention/rglru mixers (ssm blocks are mixer-only)
                n += self.d_model  # pre-mlp norm
                if self.moe is not None:
                    e = self.moe
                    n += self.d_model * e.num_experts   # router
                    ff = 3 * self.d_model * e.d_expert
                    n += (e.num_experts if not active_only else e.top_k) * ff
                else:
                    n += 3 * self.d_model * self.d_ff
        n += self.d_model  # final norm
        return n

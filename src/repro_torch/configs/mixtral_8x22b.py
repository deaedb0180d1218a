"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_expert=16384 vocab=32768 [arXiv:2401.04088].

The reference's config also carries ``sharding_overrides`` (TP within each
expert: 8 experts do not divide its 16-way model axis); the port's
``ModelConfig`` has no sharding fields yet (ROADMAP queue A.15), so the
copy drops that field and keeps every other.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    attn_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=16384),
    # int8 expert weights in the serve-time specs (model_specs(serve=True))
    quant_experts_serve=True,
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=64,
    vocab_size=128,
    attn_window=16,
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=64, capacity_factor=8.0),
    attn_chunk=16,
    loss_chunk=16,
)

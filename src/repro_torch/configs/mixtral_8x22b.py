"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_expert=16384 vocab=32768 [arXiv:2401.04088].

Sharding note: 8 experts do not divide a 16-way model axis, so Mixtral
splits each expert's MLP dim over "model" instead of the experts
(``sharding_overrides``, the reference's).
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
    sharding_overrides={
        "train": {"experts": None, "expert_mlp": "model"},
        "serve": {"experts": None, "expert_mlp": "model"},
    },
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

"""moonshot-v1-16b-a3b [moe] — Moonlight 64-expert top-6 MoE.

48L d_model=2048 16H (kv=16) d_expert=1408 vocab=163840
[hf:moonshotai/Moonlight-16B-A3B].
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408),
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab_size=128,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, capacity_factor=8.0),
    attn_chunk=16,
    loss_chunk=16,
)

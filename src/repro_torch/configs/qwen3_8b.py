"""qwen3-8b [dense] — GQA + qk-norm.

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936 [hf:Qwen/Qwen3-8B].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-8b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=128,
    qk_norm=True,
    attn_chunk=16,
    loss_chunk=16,
)

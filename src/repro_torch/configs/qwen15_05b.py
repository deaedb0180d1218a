"""qwen1.5-0.5b [dense] — QKV bias; natural "edge tier" variant.

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936 [hf:Qwen/Qwen1.5-0.5B].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-0.5b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    qkv_bias=True,
    attn_chunk=16,
    loss_chunk=16,
)

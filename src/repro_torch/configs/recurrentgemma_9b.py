"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 ratio.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000 [arXiv:2402.19427].
"""
from repro_torch.models.config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    attn_window=2048,
    layer_pattern=("rglru", "rglru", "attn"),
    rglru=RGLRUConfig(lru_width=4096, conv_width=4),
    tie_embeddings=True,
    mlp_activation="gelu",
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    num_layers=5,  # exercises remainder segment (5 = 1x3 + 2)
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    attn_window=16,
    layer_pattern=("rglru", "rglru", "attn"),
    rglru=RGLRUConfig(lru_width=64, conv_width=4),
    tie_embeddings=True,
    mlp_activation="gelu",
    attn_chunk=16,
    loss_chunk=16,
)

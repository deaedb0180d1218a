"""yi-34b [dense] — llama-arch GQA.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 [arXiv:2403.04652].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
)

SMOKE = ModelConfig(
    name="yi-34b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=128,
    attn_chunk=16,
    loss_chunk=16,
)

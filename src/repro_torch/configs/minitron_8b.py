"""minitron-8b [dense] — pruned nemotron.

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000 [arXiv:2407.14679].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
)

SMOKE = ModelConfig(
    name="minitron-8b-smoke",
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

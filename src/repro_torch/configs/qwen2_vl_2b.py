"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 [arXiv:2409.12191].
The vision front end is a stub: the caller passes precomputed patch
embeddings and (t, h, w) position ids to ``prefill`` / ``decode_step``
(``{"embeddings": (B, S, d), "positions": (B, 3, S)}``).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mrope=True,
    mrope_sections=(16, 24, 24),
    embed_inputs=False,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-vl-2b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    mrope=True,
    mrope_sections=(2, 3, 3),
    embed_inputs=False,
    attn_chunk=16,
    loss_chunk=16,
)

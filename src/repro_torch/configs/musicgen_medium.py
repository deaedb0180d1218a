"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048 [arXiv:2306.05284].
The EnCodec front end is a stub: the caller passes precomputed frame
embeddings to ``prefill`` / ``decode_step`` (``{"embeddings": (B, S, d)}``).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    embed_inputs=False,
    mlp_activation="gelu",
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    embed_inputs=False,
    mlp_activation="gelu",
    attn_chunk=16,
    loss_chunk=16,
)

"""falcon-mamba-7b [ssm] — attention-free Mamba-1.

64L d_model=4096 vocab=65024, ssm_state=16 [arXiv:2410.05355].
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=8,       # unused (attention-free); kept nonzero for uniform code paths
    num_kv_heads=8,
    head_dim=64,
    d_ff=0,            # mamba blocks are mixer-only
    vocab_size=65024,
    layer_pattern=("ssm",),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke",
    family="ssm",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=0,
    vocab_size=128,
    layer_pattern=("ssm",),
    ssm=SSMConfig(d_state=4, d_conv=4, expand=2),
    attn_chunk=16,
    loss_chunk=16,
)

"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64
[arXiv:2411.15242].  Pattern: 5 Mamba2 blocks then one *shared* attention
block (one weight set reused at every slot) — 13 full units + 3 tail mambas.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
    rope_theta=1.0e4,
)

SMOKE = CONFIG.with_(
    n_layers=7,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=16,
    pattern=("mamba", "mamba", "shared_attn"),
    dtype="float32",
)

"""qwen2.5-14b [dense]: GQA + QKV bias.

48L d_model=5120 40H (kv=8) d_ff=13824 vocab=152064 [hf:Qwen/Qwen2.5].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1.0e6,
)

SMOKE = CONFIG.with_(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    dtype="float32",
)

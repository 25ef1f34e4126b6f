"""qwen3-8b [dense]: GQA + qk_norm.

36L d_model=4096 32H (kv=8) d_ff=12288 vocab=151936 [hf:Qwen/Qwen3-8B].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
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

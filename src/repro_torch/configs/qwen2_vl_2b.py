"""qwen2-vl-2b [vlm]: LM backbone with M-RoPE; the vision frontend is a STUB
— ``input_specs()`` provides token ids plus the [3, B, S] (t/h/w) M-RoPE
position grid a real frontend would emit.

28L d_model=1536 12H (kv=2) d_ff=8960 vocab=151936 [arXiv:2409.12191].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    mrope=True,
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

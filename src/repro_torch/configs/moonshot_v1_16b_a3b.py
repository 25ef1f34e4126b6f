"""moonshot-v1-16b-a3b [moe]: Moonlight-16B-A3B-style MoE.

48L d_model=2048 16H (kv=16) moe_d_ff=1408 vocab=163840, 64 experts top-6
(+2 shared experts, first layer dense — hf:moonshotai/Moonlight-16B-A3B).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,            # dense first layer (hf intermediate_size)
    vocab_size=163840,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    first_k_dense=1,
    rope_theta=5.0e4,
)

SMOKE = CONFIG.with_(
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    n_experts=8,
    n_shared_experts=1,
    moe_top_k=2,
    moe_d_ff=32,
    first_k_dense=1,
    dtype="float32",
)

"""deepseek-v2-236b [moe]: MLA + 160-expert MoE.

60L d_model=5120 128H, MLA kv_lora=512 q_lora=1536 (qk_nope=128 qk_rope=64
v_head=128), moe_d_ff=1536, 2 shared + 160 routed top-6, first layer dense,
vocab=102400 [arXiv:2405.04434].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,        # MLA: per-head keys materialized from the latent
    d_ff=12288,            # dense first layer
    vocab_size=102400,
    head_dim=192,          # qk_nope + qk_rope (used for sizing only)
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1536,
    first_k_dense=1,
    rope_theta=1.0e4,
)

SMOKE = CONFIG.with_(
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=48,
    q_lora_rank=32,
    kv_lora_rank=16,
    rope_head_dim=16,
    nope_head_dim=32,
    v_head_dim=32,
    n_experts=8,
    n_shared_experts=1,
    moe_top_k=2,
    moe_d_ff=32,
    first_k_dense=1,
    dtype="float32",
)

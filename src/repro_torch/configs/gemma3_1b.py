"""gemma3-1b [dense]: 5:1 local:global attention, MQA, tied embeddings.

26L d_model=1152 4H (kv=1) d_ff=6912 vocab=262144, sliding window 512,
head_dim=256 [hf:google/gemma-3-1b-pt].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    sliding_window=512,
    local_global_ratio=5,
    tie_embeddings=True,
    rope_theta=1.0e6,
    pattern=(
        "attn_local", "attn_local", "attn_local", "attn_local",
        "attn_local", "attn_global",
    ),
)

SMOKE = CONFIG.with_(
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    sliding_window=8,
    pattern=("attn_local", "attn_global"),
    dtype="float32",
)

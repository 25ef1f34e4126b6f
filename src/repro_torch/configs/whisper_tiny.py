"""whisper-tiny [audio]: encoder-decoder backbone; conv frontend is a STUB —
``input_specs()`` feeds precomputed frame embeddings [B, S, d].

4L enc + 4L dec, d_model=384 6H (kv=6) d_ff=1536 vocab=51865
[arXiv:2212.04356].  Sinusoidal positions, GELU MLP, no RoPE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                # decoder layers
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    is_encoder_decoder=True,
    use_rope=False,
)

SMOKE = CONFIG.with_(
    n_layers=2,
    n_encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    dtype="float32",
)

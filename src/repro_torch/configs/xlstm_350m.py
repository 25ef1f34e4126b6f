"""xlstm-350m [ssm]: sLSTM + mLSTM blocks (xLSTM[7:1]).

24L d_model=1024 4H d_ff=0 vocab=50304 [arXiv:2405.04517].  Pattern: 7
mLSTM blocks then 1 sLSTM block (3 scanned units).  No attention, no KV
cache — O(1) recurrent state makes long_500k native; the paper's
aggregated-KV technique is inapplicable (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    use_rope=False,
    pattern=(
        "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm",
        "slstm",
    ),
)

SMOKE = CONFIG.with_(
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    vocab_size=256,
    pattern=("mlstm", "slstm"),
    dtype="float32",
)

"""Optimizer substrate: AdamW + schedules + gradient compression."""
from repro_torch.optim.optimizer import (  # noqa: F401
    AdamState, AdamWConfig, init_state, apply_updates, schedule, global_norm,
)
from repro_torch.optim.grad_compression import (  # noqa: F401
    ErrorFeedback, init_error_feedback, compress_topk,
)

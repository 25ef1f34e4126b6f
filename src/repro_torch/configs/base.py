"""Model configuration of the port: the architecture record shared by every
model, and the grid of shape cells the dry run sweeps, as
``src/repro/configs/base.py`` defines them (the port keeps its own
copy and imports nothing of the JAX package).

The fields name every architecture family the JAX package knows, and the
port's model code runs each of them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # attention details
    use_rope: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1.0e4
    sliding_window: int = 0          # 0 -> no local attention anywhere
    local_global_ratio: int = 0      # gemma3: 5 local layers per global
    mrope: bool = False              # qwen2-vl

    # MLA (deepseek-v2)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0           # leading dense-FFN layers (deepseek-v2)
    router_scale: float = 1.0
    capacity_factor: float = 1.25
    # EP dispatch: "all_gather" (baseline: gather every token to every rank)
    # or "all_to_all" (§Perf: per-destination send buffers, bf16)
    moe_dispatch: str = "all_gather"

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1

    # layer pattern for heterogeneous stacks; names from:
    #   attn, mamba, shared_attn, mlstm, slstm
    # The stack is ceil(n_layers / len(pattern)) repetitions truncated to
    # n_layers blocks.  Homogeneous dense archs use ("attn",).
    pattern: tuple = ("attn",)

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1.0e-6
    dtype: str = "bfloat16"
    # scan-over-units (compile-time O(1) in depth).  False unrolls the unit
    # loop — used by the dry-run calibration pass, where XLA's cost analysis
    # must see every layer (while bodies are counted once by the analyzer).
    scan_layers: bool = True
    # Archs whose mixers cannot use tensor parallelism (e.g. xlstm's 4
    # heads) fold the model axis into data parallelism: params replicated/
    # FSDP over all axes, batch sharded over all axes, no per-block
    # sequence gathers (§Perf; see EXPERIMENTS.md).
    prefer_pure_dp: bool = False

    # AccurateML aggregated-KV serving (the paper's technique; DESIGN.md §2.1)
    agg_kv: bool = False             # enable two-stage decode attention
    agg_compression: int = 64        # tokens per KV bucket (paper's r)
    agg_refine_frac: float = 0.05    # fraction of buckets re-attended exactly
    # "flat": tokens in insertion order, stage 2 masks (paper-faithful
    #         baseline; reads O(S) bytes/step).
    # "bucket_major": per-bucket slot arrays, stage 2 gathers only refined
    #         buckets (beyond-paper §Perf layout; reads O(K + eps*S)).
    agg_layout: str = "flat"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(
                self, "head_dim", self.d_model // self.n_heads
            )

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- derived -----------------------------------------------------------
    def block_kinds(self) -> tuple:
        """Per-layer block kind, length n_layers."""
        reps = -(-self.n_layers // len(self.pattern))
        return tuple((self.pattern * reps)[: self.n_layers])


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def param_count(cfg: ModelConfig) -> int:
    """Approximate parameter count (embeddings + blocks)."""
    d = cfg.d_model
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    kinds = cfg.block_kinds()
    hd = cfg.head_dim
    for i, kind in enumerate(kinds):
        if kind in ("attn", "shared_attn"):
            if kind == "shared_attn" and i != kinds.index("shared_attn"):
                pass  # shared weights counted once
            elif cfg.mla:
                q_in = cfg.q_lora_rank or d
                total += d * (cfg.q_lora_rank or 0)
                total += q_in * cfg.n_heads * (
                    cfg.nope_head_dim + cfg.rope_head_dim
                )
                total += d * (cfg.kv_lora_rank + cfg.rope_head_dim)
                total += cfg.kv_lora_rank * cfg.n_heads * (
                    cfg.nope_head_dim + cfg.v_head_dim
                )
                total += cfg.n_heads * cfg.v_head_dim * d
            else:
                total += d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
        if kind == "mamba":
            d_in = cfg.ssm_expand * d
            total += d * (2 * d_in + 2 * cfg.ssm_groups * cfg.ssm_state)
            total += d_in * d
        if kind in ("mlstm", "slstm"):
            total += 4 * d * d  # q/k/v/o-ish projections
        # FFN
        if kind in ("attn", "mamba", "mlstm", "slstm"):
            if cfg.n_experts > 0 and i >= cfg.first_k_dense:
                total += (
                    cfg.n_experts + cfg.n_shared_experts
                ) * 3 * d * cfg.moe_d_ff + d * cfg.n_experts
            elif cfg.d_ff > 0:
                total += 3 * d * cfg.d_ff
    if cfg.is_encoder_decoder:
        total += cfg.n_encoder_layers * (4 * d * hd * cfg.n_heads + 2 * d * cfg.d_ff)
        total += cfg.n_layers * 4 * d * hd * cfg.n_heads  # cross attention
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Active (per-token) parameters — MoE counts top_k + shared experts."""
    if cfg.n_experts == 0:
        return param_count(cfg)
    full = param_count(cfg)
    kinds = cfg.block_kinds()
    n_moe = sum(
        1 for i, k in enumerate(kinds)
        if k in ("attn", "mamba", "mlstm", "slstm") and i >= cfg.first_k_dense
    )
    d = cfg.d_model
    inactive = n_moe * (
        (cfg.n_experts - cfg.moe_top_k) * 3 * d * cfg.moe_d_ff
    )
    return full - inactive

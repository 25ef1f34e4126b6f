"""repro_torch.serve.lm — LM decoding as a first-class anytime workload.

The aggregated-KV attention of ``models/aggregated_kv.py`` (the paper's
two-stage algorithm on the KV cache) wired into the serving stack:

  * ``DecodeEngine`` — slot-based continuous batching with a prefill /
    insert / generate-step API over per-layer aggregated caches; each
    step takes a *per-step* ``refine_frac`` (the decode-side eps).
  * ``LMServable`` — plugs the engine into ``Server``/``FrontDoor`` so a
    generation request gets the full anytime treatment: deadline-granted
    refine_frac, fleet-wide load-shed coarsening, stage-1-vs-refined
    token-disagreement accuracy proxy, ``partial_shards`` degrades.
  * ``BucketShardPlan`` — bucket-striped failure domains; shard death is
    a degraded answer, never an error.
"""
from repro_torch.serve.lm.engine import DecodeEngine, Prefix  # noqa: F401
from repro_torch.serve.lm.servable import LMServable, lm_pad_sizes  # noqa: F401
from repro_torch.serve.lm.sharded import BucketShardPlan  # noqa: F401

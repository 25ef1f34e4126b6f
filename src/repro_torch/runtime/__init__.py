"""Fault-tolerance / elasticity runtime.

``fault_tolerance`` is the training-side control plane (heartbeats,
checkpoint/restart, straggler eps-shrink); ``shards`` is the serving-side
failure-domain layer (per-shard timeout/hedging/kill-and-recover behind
the ``Servable`` protocol); ``chaos`` is the deterministic fault injector
both are tested against.
"""
from repro_torch.runtime.chaos import (  # noqa: F401
    ChaosEvent, ChaosInjector, ShardDead, corrupt_snapshot_dir,
)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    FailureInjector, Heartbeat, Supervisor,
)
from repro_torch.runtime.shards import (  # noqa: F401
    ShardedServable, sharded_knn,
)

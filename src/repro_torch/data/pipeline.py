"""Deterministic sharded input pipeline with host-side prefetch, as
``src/repro/data/pipeline.py`` generates it: the same numpy draws, so both
packages give the same batches to the bit.

  * deterministic addressing — batch ``i`` of shard ``s`` is a pure function
    of (seed, i, s), so restart/elastic-reshard resume is sample-exact with
    no pipeline state beyond the step counter;
  * shard-aware — each data-parallel rank draws only its slice;
  * double-buffered host prefetch thread hides generation latency.

Batches come out as tensors on the pipeline's device (the card unless the
caller asks for the CPU).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.device import resolve


class TokenPipeline:
    def __init__(
        self, cfg, *, global_batch: int, seq_len: int, seed: int = 0,
        shard_index: int = 0, shard_count: int = 1, prefetch: int = 2,
        device: str | torch.device = "cuda",
    ):
        if global_batch % shard_count:
            raise ValueError(f"global_batch {global_batch} is not a "
                             f"multiple of shard_count {shard_count}")
        self.cfg = cfg
        self.local_batch = global_batch // shard_count
        self.seq = seq_len
        self.seed = seed
        self.shard = shard_index
        self.shards = shard_count
        self.prefetch = prefetch
        self.device = resolve(device)

    # deterministic batch addressing ------------------------------------
    def _make_batch(self, step: int) -> dict[str, Any]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard])
        )
        v = self.cfg.vocab_size
        tokens = rng.integers(
            0, v, size=(self.local_batch, self.seq + 1), dtype=np.int32
        )
        batch = {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:],
        }
        if self.cfg.is_encoder_decoder:
            batch["frames"] = rng.standard_normal(
                (self.local_batch, self.seq, self.cfg.d_model),
                dtype=np.float32,
            )
        if self.cfg.mrope:
            pos = np.broadcast_to(
                np.arange(self.seq, dtype=np.int32)[None, None],
                (3, self.local_batch, self.seq),
            )
            batch["mrope_positions"] = pos
        return batch

    def _to_device(self, batch: dict[str, np.ndarray]) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        return self._to_device(self._make_batch(step))

    # prefetching iterator ----------------------------------------------
    def iterate(self, start_step: int = 0) -> Iterator[dict[str, Any]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self._make_batch(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield self._to_device(q.get())
        finally:
            stop.set()

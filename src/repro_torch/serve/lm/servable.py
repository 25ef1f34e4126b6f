"""``LMServable``: generation as an anytime workload on the existing server.

The adapter that makes "LM serving rides the same scheduler/deadline path"
literally true.  The mapping onto the ``Servable`` contract:

  * ``n_points`` is the aggregate's bucket count K, so the controller's
    ``refine_budget = ceil(eps * K)`` IS the number of exactly re-attended
    buckets per decode step, and ``refine_frac = refine_budget / K``
    recovers the granted eps — refine_frac *is* the decode-side eps.  The
    load-shed ladder's fleet-wide ``eps_max`` scaling therefore coarsens
    decode for free.
  * ``build``/``cache_key`` hand the long-lived ``DecodeEngine`` to the
    aggregate cache (one engine, every compression ratio — the engine's
    aggregation ratio is baked into its caches).
  * ``run(refine_budget=0)`` is the stage-1 answer: greedy generation at
    pure-centroid attention (refine_frac=0); ``run(refine_budget=b)``
    regenerates at ``refine_frac=b/K``.  Both start from the same *exact*
    prefill, so token 0 always agrees and the stage-1-vs-refined token
    disagreement is a faithful accuracy proxy.

Batching: the engine's decode batch is ``[max_slots]``, so a server
wrapping this servable must use scheduler pad sizes capped at
``max_slots`` (see ``lm_pad_sizes``); ``run`` guards against oversized
batches loudly.

The engine runs on its model's device; its logits and tokens come back to
the host once a step (``.cpu()``, which waits for the card), so ``run``
returns numpy arrays wherever the engine runs.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from repro_torch.obs.trace import current_tracer
from repro_torch.serve.lm.engine import DecodeEngine


def lm_pad_sizes(max_slots: int) -> tuple[int, ...]:
    """Power-of-two scheduler pad sizes that fit the engine's slot batch."""
    if max_slots < 1:
        raise ValueError("max_slots must be >= 1")
    sizes = [1]
    while sizes[-1] * 2 <= max_slots:
        sizes.append(sizes[-1] * 2)
    return tuple(sizes)


class LMServable:
    """Greedy generation over a ``DecodeEngine`` under the anytime contract."""

    def __init__(
        self,
        engine: DecodeEngine,
        *,
        prompt_len: int,
        max_new_tokens: int,
        name: str = "lm",
    ):
        if prompt_len < 1 or prompt_len >= engine.s_max:
            raise ValueError(
                f"prompt_len {prompt_len} outside [1, {engine.s_max})"
            )
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt_len + max_new_tokens > engine.s_max:
            raise ValueError(
                "prompt_len + max_new_tokens exceeds the engine's s_max"
            )
        self.engine = engine
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.name = name
        self.last_shuffle_bytes = 0
        self.last_deadline_remaining: float | None = None
        self._m_disagree = engine.registry.reservoir(
            "lm_token_disagreement",
            "per-request stage-1 vs refined token disagreement",
        )

    # ------------------------------------------------------------------
    # Servable surface
    # ------------------------------------------------------------------
    @property
    def n_points(self) -> int:
        # K buckets: eps_to_budget(K, eps) = ceil(eps*K) refined buckets.
        return self.engine.n_buckets

    def cache_key(self, compression_ratio: float):
        # One engine serves every ratio: its aggregation ratio is baked
        # into the caches at construction.
        return (self.name, "engine", id(self.engine))

    def build(self, compression_ratio: float) -> DecodeEngine:
        return self.engine

    def probe_payload(self) -> tuple:
        vocab = self.engine.cfg.vocab_size
        return (
            (np.arange(self.prompt_len, dtype=np.int32) % vocab),
        )

    def pad_batch(self, payloads: Sequence[tuple], batch: int) -> tuple:
        rows = [np.asarray(p[0], dtype=np.int32) for p in payloads]
        for r in rows:
            if r.shape != (self.prompt_len,):
                raise ValueError(
                    f"prompt shape {r.shape} != ({self.prompt_len},)"
                )
        while len(rows) < batch:
            rows.append(rows[0])      # replicate, batch-axis padding only
        return (np.stack(rows[:batch]),)

    def run(
        self, prepared: DecodeEngine, batch_payload: tuple,
        *, refine_budget: int,
    ) -> dict:
        engine = prepared
        tokens = np.asarray(batch_payload[0])
        bsz = tokens.shape[0]
        if bsz > engine.max_slots:
            raise ValueError(
                f"batch {bsz} exceeds max_slots {engine.max_slots}: build "
                f"the server with ContinuousBatcher(pad_sizes="
                f"lm_pad_sizes({engine.max_slots}))"
            )
        rf = (
            min(1.0, refine_budget / self.n_points)
            if refine_budget > 0 else 0.0
        )

        engine.free_all()
        tok_cols: list[np.ndarray] = []
        logit_cols: list[np.ndarray] = []
        first_tok = np.zeros((bsz,), np.int32)
        first_logits = []
        for i in range(bsz):
            pf = engine.prefill(tokens[i])
            engine.insert(pf, i)
            first_tok[i] = pf.next_token
            first_logits.append(pf.logits.cpu().numpy())
        tok_cols.append(first_tok)
        logit_cols.append(np.stack(first_logits))

        def generate():
            for _ in range(self.max_new_tokens - 1):
                nxt, lg = engine.generate_step(rf)
                tok_cols.append(nxt[:bsz].cpu().numpy())
                logit_cols.append(lg[:bsz].cpu().numpy())

        if refine_budget > 0:
            with current_tracer().span(
                "decode.refine", refine_frac=rf, refine_budget=refine_budget,
            ):
                generate()
        else:
            generate()

        self.last_shuffle_bytes = (
            engine.step_bytes(rf) * max(0, self.max_new_tokens - 1)
        )
        return {
            "tokens": np.stack(tok_cols, axis=1),       # [B, T] int32
            "logits": np.stack(logit_cols, axis=1),     # [B, T, V] f32
        }

    def unpack(self, outputs: dict, n: int) -> list:
        return [
            {"tokens": outputs["tokens"][i], "logits": outputs["logits"][i]}
            for i in range(n)
        ]

    # ------------------------------------------------------------------
    # optional surfaces the server discovers with getattr
    # ------------------------------------------------------------------
    def accuracy_proxy(
        self, stage1_out: dict, refined_out: dict, n: int
    ) -> list[float]:
        """Per-request stage-1 vs refined top-1 token disagreement in
        [0, 1] (0.0 = refinement changed no emitted token)."""
        out = []
        for i in range(n):
            d = float(np.mean(
                stage1_out["tokens"][i] != refined_out["tokens"][i]
            ))
            self._m_disagree.observe(d)
            out.append(d)
        return out

    def on_batch_deadline(self, remaining_s: float) -> None:
        self.last_deadline_remaining = remaining_s

    @property
    def last_partial_shards(self) -> tuple[int, ...]:
        return tuple(sorted(self.engine.dead_shards))

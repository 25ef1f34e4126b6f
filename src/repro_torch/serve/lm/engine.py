"""Aggregated-KV decode engine of the port: slot-based continuous batching
over the paper's two-stage attention, as
``src/repro/serve/lm/engine.py:DecodeEngine`` serves it.

``DecodeEngine`` owns one fixed ``[max_slots]`` decode batch of per-layer
decode state (``AggKVCache`` / ``BucketMajorKVCache`` for the aggregated
attention layers; ring buffers, Mamba2 and xLSTM states and cross-attention
memory for the other block kinds) and serves three verbs:

  * ``prefill(tokens)``: run the prompt through the model token by token
    (batch 1, ``serve_step``) at ``refine_frac=1.0``: prefill is exact, the
    approximation is a decode-time knob; returns a ``Prefix``;
  * ``insert(prefix, slot)``: copy the prefix's batch-1 cache state into a
    slot of the engine batch, in place on the card; the prefix stays as it
    was, so it can be inserted again;
  * ``generate_step(refine_frac)``: one decode step for every slot at a
    per-step refine fraction, ``ceil(refine_frac * K)`` buckets re-attended
    exactly.

Failure domains: buckets stripe over shards (``BucketShardPlan``);
``kill_shard`` zeroes the dead buckets' counts, so they stop contributing
(the empty-bucket masking path), and the mask is applied again after every
change of the state while shards stay dead.

Every LSH draw is made once, at construction, and shared by the engine
batch and every prefix, which ``insert`` relies on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.models.aggregated_kv import refine_count
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.trace import current_tracer
from repro_torch.serve.lm.sharded import BucketShardPlan

@dataclasses.dataclass(frozen=True)
class Prefix:
    """Prefilled per-sequence decode state, ready to insert into a slot."""

    caches: list              # batch-1 decode caches, one per layer
    next_token: int           # argmax of the prompt's final-position logits
    logits: torch.Tensor      # [vocab_padded] f32 final-position logits
    length: int               # prompt tokens consumed (next insert position)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _copy_into_slot(state, prefix, slot: int, name: str = "cache") -> None:
    """Copy a batch-1 cache into ``slot`` of the engine's cache, leaf by
    leaf, as the JAX package's ``_insert_jit`` places them by shape:
    batch-leading leaves at ``slot``, leaves of the same shape (the shared
    LSH draws) whole.  A cache is an aggregated cache's dataclass, a dict
    (exact or ring-buffer K / V, Mamba2's conv windows and state, an
    encoder-decoder block's self and cross caches) or a tuple (the conv
    windows, an xLSTM state, the cross K / V) of such, down to tensors."""
    if dataclasses.is_dataclass(state):
        for f in dataclasses.fields(state):
            _copy_into_slot(getattr(state, f.name), getattr(prefix, f.name),
                            slot, f"{name}.{f.name}")
    elif isinstance(state, dict):
        for key, ds in state.items():
            _copy_into_slot(ds, prefix[key], slot, f"{name}.{key}")
    elif isinstance(state, (tuple, list)):
        for i, (ds, pf) in enumerate(zip(state, prefix)):
            _copy_into_slot(ds, pf, slot, f"{name}[{i}]")
    elif state is prefix:
        return
    elif state.shape == prefix.shape:
        state.copy_(prefix)
    elif prefix.shape[0] == 1 and state.shape[1:] == prefix.shape[1:]:
        state[slot].copy_(prefix[0])
    else:
        raise ValueError(f"cannot place prefix leaf {name} "
                         f"{tuple(prefix.shape)} into {tuple(state.shape)}")


class DecodeEngine:
    """Slot-based continuous-batching decode over aggregated KV caches.

    ``model`` is an ``LM`` (``models.model.init_params``); the engine runs
    on its device.  ``lsh`` gives every layer's LSH draws (the layout of
    ``models.model.draw_lsh``); otherwise they are drawn from ``generator``
    (a generator seeded 0 on the model's device when None).
    """

    def __init__(
        self, model, cfg, *, max_slots: int, s_max: int,
        generator: torch.Generator | None = None, lsh: list | None = None,
        n_shards: int = 1, registry: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if not cfg.agg_kv:
            raise ValueError(
                "DecodeEngine requires cfg.agg_kv=True (aggregated caches)")
        if max_slots < 1:
            raise ValueError("need at least one slot")
        self.model = model
        self.cfg = cfg
        self.max_slots = max_slots
        self.s_max = s_max
        self.clock = clock
        self.device = model.embed.device
        if lsh is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            lsh = model_lib.draw_lsh(cfg, generator, device=self.device)
        self.lsh = lsh
        self.state = self._empty_caches(max_slots)
        self.n_buckets = max(1, s_max // cfg.agg_compression)
        self.shard_plan = BucketShardPlan(self.n_buckets, n_shards)
        self._dead: set[int] = set()
        self._keep = torch.ones(self.n_buckets, dtype=torch.bool,
                                device=self.device)

        self._live = np.zeros(max_slots, dtype=bool)
        self._pos_host = np.zeros(max_slots, dtype=np.int64)
        self.pos = torch.zeros(max_slots, dtype=torch.int32,
                               device=self.device)
        self.last_token = torch.zeros(max_slots, dtype=torch.int32,
                                      device=self.device)

        self.registry = registry if registry is not None \
            else default_registry()
        self._m_tokens = self.registry.counter(
            "lm_decode_tokens_total", "tokens emitted across live slots")
        self._m_prefills = self.registry.counter(
            "lm_prefill_total", "prompts prefilled")
        self._m_step_s = self.registry.reservoir(
            "lm_decode_step_latency_s", "wall seconds per fused decode step")
        self._m_rf = self.registry.gauge(
            "lm_decode_refine_frac", "refine_frac of the latest decode step")

    def _empty_caches(self, batch: int) -> list:
        return model_lib.init_caches(self.cfg, batch=batch, s_max=self.s_max,
                                     device=self.device, lsh=self.lsh)

    # ------------------------------------------------------------------
    # slots
    # ------------------------------------------------------------------
    @property
    def live_slots(self) -> list[int]:
        return [i for i in range(self.max_slots) if self._live[i]]

    @property
    def free_slots(self) -> list[int]:
        return [i for i in range(self.max_slots) if not self._live[i]]

    def free(self, slot: int) -> None:
        self._live[slot] = False

    def free_all(self) -> None:
        self._live[:] = False

    # ------------------------------------------------------------------
    # failure domains
    # ------------------------------------------------------------------
    @property
    def dead_shards(self) -> frozenset[int]:
        return frozenset(self._dead)

    def kill_shard(self, shard: int) -> None:
        """Drop a failure domain: its buckets' counts go to zero on the whole
        engine batch (they stop contributing centroids and stop being
        refinable) and stay masked until revival."""
        if not 0 <= shard < self.shard_plan.n_shards:
            raise ValueError(f"shard {shard} out of range")
        self._dead.add(shard)
        self._keep = torch.as_tensor(self.shard_plan.keep_mask(self._dead),
                                     device=self.device)
        self._apply_dead_mask(self.state)

    def revive_shards(self) -> None:
        """Clear the dead set.  Zeroed counts stay zero: what the dead shards
        held returns only by a new prefill."""
        self._dead.clear()
        self._keep = torch.ones(self.n_buckets, dtype=torch.bool,
                                device=self.device)

    def _apply_dead_mask(self, caches: list) -> None:
        if not self._dead:
            return
        for c in model_lib.aggregated_caches(caches):
            c.counts.masked_fill_(~self._keep, 0)

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    def prefill(self, tokens) -> Prefix:
        """Run a prompt through the model at exact attention; batch 1."""
        toks = torch.as_tensor(np.asarray(tokens, dtype=np.int64).reshape(-1),
                               device=self.device)
        length = int(toks.shape[0])
        if not 1 <= length < self.s_max:
            raise ValueError(
                f"prompt length {length} outside [1, {self.s_max})")
        cfg1 = self.cfg.with_(agg_refine_frac=1.0)
        positions = torch.arange(length, dtype=torch.int32,
                                 device=self.device)
        with current_tracer().span("decode.prefill", length=length):
            caches = self._empty_caches(1)
            for t in range(length):
                logits, caches = model_lib.serve_step(
                    self.model, caches, toks[t:t + 1].reshape(1, 1),
                    positions[t:t + 1], cfg1)
            logits = logits[0].float()
            next_token = int(torch.argmax(logits))
        self._m_prefills.inc()
        return Prefix(caches=caches, next_token=next_token, logits=logits,
                      length=length)

    # ------------------------------------------------------------------
    # insert
    # ------------------------------------------------------------------
    def insert(self, prefix: Prefix, slot: int) -> None:
        """Admit a prefilled sequence into a slot of the decode batch."""
        if not 0 <= slot < self.max_slots:
            raise ValueError(f"slot {slot} out of range")
        if self._live[slot]:
            raise ValueError(f"slot {slot} is live; free() it first")
        _copy_into_slot(self.state, prefix.caches, slot)
        self._apply_dead_mask(self.state)
        self.pos[slot] = prefix.length
        self._pos_host[slot] = prefix.length
        self.last_token[slot] = prefix.next_token
        self._live[slot] = True

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def generate_step(
        self, refine_frac: float
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One decode step for every slot.

        Returns ``(tokens [max_slots] int32, logits [max_slots,
        vocab_padded] f32)`` on the engine's device, after the card has
        finished the step.  Slots that are not live keep their token; their
        logits are garbage.  Callers index by the slots they own.
        """
        if not self._live.any():
            raise RuntimeError("generate_step with no live slots")
        if np.any(self._pos_host[self._live] >= self.s_max):
            raise RuntimeError("a live slot exhausted s_max")
        n_live = int(self._live.sum())
        cfg_rf = self.cfg.with_(agg_refine_frac=refine_frac)
        t0 = self.clock()
        with current_tracer().span("decode.step", refine_frac=refine_frac,
                                   live=n_live):
            live = torch.as_tensor(self._live, device=self.device)
            logits, _ = model_lib.serve_step(
                self.model, self.state, self.last_token[:, None], self.pos,
                cfg_rf)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            self.last_token = torch.where(live, nxt, self.last_token)
            self.pos = torch.where(live, self.pos + 1, self.pos)
            logits = logits.float()
            _sync(self.device)
        self._apply_dead_mask(self.state)
        self._pos_host[self._live] += 1
        self._m_tokens.inc(n_live)
        self._m_step_s.observe(self.clock() - t0)
        self._m_rf.set(refine_frac)
        return self.last_token.clone(), logits

    # ------------------------------------------------------------------
    # modelled cost
    # ------------------------------------------------------------------
    def step_bytes(self, refine_frac: float) -> int:
        """Modelled device-memory bytes of one decode step's attention
        reads: K centroid K/V pairs (f32) plus the refined buckets' exact
        slots, the O(K + eps S) skip."""
        cfg = self.cfg
        k = self.n_buckets
        r = refine_count(refine_frac, k)
        hkv = max(1, cfg.n_kv_heads)
        hd = cfg.head_dim
        item = torch.empty((), dtype=layers.torch_dtype(cfg.dtype)) \
            .element_size()
        cent = 2 * k * hkv * hd * 4
        refined = 2 * r * 2 * cfg.agg_compression * hkv * hd * item
        return int(cfg.n_layers * self.max_slots * (cent + refined))

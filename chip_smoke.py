#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one card: Algorithm 1 (kNN
and user-based CF) and aggregated-KV LM decode.

Run from the repository root, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

What it does, in order:

1. builds the ten CUDA kernels from ``src/repro_torch/csrc`` with nvcc
   (one process per source, in parallel) and prints each kernel's register
   and spill count from ``-Xptxas=-v``;
2. drives the port's main paths through their entry points, each at the
   scale of the paper's dataset or the model's full width, with every
   kernel's launch count set to 0 just before the path and read just
   after; a kernel of the path that never launched fails the run:

   * kNN (mfeat-factors: 2.3 M points x 217 features x 10 classes; 1024
     test queries; 8 map shards): ``run_exact``, ``run_sampled``,
     ``run_accurateml`` at compression 100 with eps_max 0 and 0.01, and one
     ``accurateml_map(..., with_bound=True)`` batch through
     ``MapReduce(mesh=None)`` with the all-gather merge + vote combine;
     every ``run_accurateml`` job must make one ``lsh_hash`` launch a shard
     (the LSH step's bucket ids, the kernel's ids epilogue), as must the CF
     path's;
   * user-based CF (the Netflix subset: 48,019 neighbourhood users x 17,700
     items, density 0.012; 1024 active users; 8 map shards): ``run_exact``,
     ``run_sampled`` at the equal-work fraction 1/20 + 0.05,
     ``run_accurateml`` at compression 20 with eps_max 0 and 0.05, each
     cold and once warm, and one ``accurateml_map(..., with_bound=True)``
     batch through ``MapReduce(mesh=None)`` with the psum combine; every
     ``run_accurateml`` job must also make one ``cf_aggregate`` launch a
     shard (the bucket statistics), the other jobs none;
   * the LSH hash phase: ``ops.lsh_hash`` (the kernel's raw hashes) on
     both paths' hash inputs (kNN shard 0's rows, CF shard 0's centred
     profiles);
   * the aggregate store (``repro_torch.store``) and the servables that
     read it, at the same sizes: a ``KNNServable`` per kNN shard (287,500 x
     217, ``PyramidSpec.for_points``: 131,072 base buckets over 9 levels,
     k 5, 4 hashes of width 4) sharing one ``AggregateStore``: ``get(100)``
     built (2,048 buckets), the 1024 queries answered at eps 0 and 0.01
     and the shards folded with ``merge_topk`` and ``majority_vote``,
     ``get(400)`` and ``get(25)`` merged, the store saved to a temporary
     directory and restored into a fresh store whose ``get(100)`` is
     restored; a ``CFServable`` per CF shard (2,048 base buckets):
     ``get(20)`` built, ``run`` at eps 0.05, ``get(80)`` and ``get(40)``
     merged; a ``StreamingAggregate`` re-ingesting kNN shard 0 in 16 uneven
     appends of 4,096-row chunks, adopted into a pyramid whose ``get(100)``
     is merged.  Checked, with the counts taken: merged levels equal cold
     builds to the bit (kNN at 400 and 25, CF at 80 and 40), the restored
     levels equal the built ones and answer alike, the streamed counts and
     index equal a cold build and its sums agree within rtol 1e-4 + atol
     1e-4, its answers equal the cold level's but at counted near-ties, at
     a full budget (shard 0, 128 queries) the store-backed labels equal
     ``exact_map``'s but at near-ties, and the CF fold's RMSE passes the CF
     path's checks; it must launch lsh_hash, distance_topk, knn_distance,
     refine_distances, candidate_topk, cf_weights, cf_refine and
     cf_aggregate;
   * aggregated-KV LM decode: qwen3-8b at full width and depth (36 layers,
     d_model 4096, 32 query over 8 KV heads of 128, d_ff 12,288, vocab
     151,936 padded to 152,064, bf16, random weights from seed 0) served by
     ``DecodeEngine`` with 4 slots, s_max 1024 and compression 16 (64
     buckets of 32 slots): four 128-token prompts prefilled once (batch 1,
     exact), then at refine_frac 0, 0.05, 0.25 and 1.0 the same prefixes
     re-inserted and 31 decode steps each, first in the bucket-major
     layout (``agg_refine_attention``), then in the flat layout
     (``aggregated_attention_decode``), both with ``distance_topk``
     selecting the buckets in its batched regime (one launch a layer for
     the four sequences: 36 a decode step at every refine_frac above 0 and
     36 a prefill token, and as many of the layout's attention kernel, the
     flat one at rf 0 too, which the run checks); per level tokens/s, step
     p50/p99, prefill ms a token, peak memory, KL and greedy-token
     agreement against rf 1.0
     (benchmarks/decode_bench.py) and the largest
     bucket count against the capacity; then decode_bench's exactness guard
     in f32 at full width, 2 layers deep: at rf 1.0 the engine's tokens
     equal an exact-attention decode's and its logits agree within 1e-4,
     in both layouts, and so do the serve phase's ``LMServable``'s at a
     full budget on the LM server's relaxed prompts (run after the serve
     phase, which serves the same bf16 weights);
   * MoE and MLA decode (the moe phase, after the LM phase): deepseek-v2-236b
     at its published widths (d_model 5,120, 128 heads, MLA ranks 1,536 /
     512, rope 64, nope 128, v 128, 160 routed experts of 1,536 plus 2
     shared, top-6, vocab 102,400) cut from 60 layers to 3 (the first
     dense, 2 MoE: 9.33 B parameters), and moonshot-v1-16b-a3b (d_model
     2,048, 16 heads of 128, 64 experts of 1,408 plus 2 shared, top-6,
     vocab 163,840) cut from 48 to 4 (2.52 B), bf16, random from seed 0,
     through ``DecodeEngine`` and the LM phase's path (4 slots, s_max
     1024, 64 buckets of 32 slots): four 128-token prompts prefilled, then
     one untimed and 6 timed decode steps at refine_frac 0, 0.25 and 1.0; deepseek in both layouts (its
     absorbed latent decode: 1 KV head, 128 query heads, 576-wide keys,
     512-wide values, the attention kernels' head and value tiles),
     moonshot flat.  Checked as the LM phase: one attention launch and
     one batched selection a layer, a prefill token and a decode step
     (none at rf 0 but the flat kernel), every kernel's prefill inputs
     captured, finite logits; then the LM phase's f32 guard,
     deepseek-v2-236b 2 layers deep without capacity drops: at rf 1.0 the
     engine's tokens equal the exact MLA decode's (``mla_decode``) and its
     logits agree within 1e-4, in both layouts.  It prints tokens/s, step
     p50, prefill ms a token and peak memory per model and layout, with
     the card's name and power limit;
   * the other five model families (the arch phase, after the moe phase),
     each at its published widths, bf16, random from seed 0, through
     ``DecodeEngine`` and the LM phase's path (4 slots, s_max 1024, 64
     buckets of 32 slots): zamba2-7b (d_model 3,584, Mamba2 of state 64
     and 112 heads of 64, the shared attention's 32 KV heads of 112, d_ff
     14,336, vocab 32,000) cut from 81 layers to 15 (two units of five
     Mamba2 blocks and the shared attention, then three Mamba2: 2
     aggregated slots on one weight set), gemma3-1b (26 layers, 22
     sliding-window layers of 512 on exact ring buffers and 4 global ones
     aggregated; 1 KV head of 256, G 4; vocab 262,144, tied), qwen2-vl-2b
     (28 layers, 2 KV heads of 128, G 6, qkv bias; the engine's path
     rotates by standard RoPE, as the JAX package's), whisper-tiny (4
     decoder and 4 encoder layers, 6 heads of 64, GELU, sinusoidal
     positions, the decoder's zero cross caches) and xlstm-350m (21 mLSTM
     and 3 sLSTM blocks of 1,024, no attention); 64-token prompts, one
     untimed and 6 timed decode steps at rf 0, 0.25 and 1.0 (xLSTM, with
     no aggregated layer, at 1.0 alone), zamba2 and gemma3 in both
     layouts, the others flat.  One table (``DECODE_MODELS``) and one
     function (``decode_phase``) serve both phases.  Checked as the moe phase,
     a launch of each kernel an aggregated layer (2, 4, 28, 4 and 0 a
     token), every kernel's prefill inputs captured at the new head
     shapes, finite logits; then each model's f32 guard one pattern unit
     deep (zamba2 6, gemma3 6, qwen2-vl 2, whisper 2 layers; xLSTM one
     mLSTM and one sLSTM block: f32 rounding at its 8-block unit drifts
     past the tolerance between any two orders of the sums), one
     prompt and 8 tokens at rf 1.0: tokens equal to the exact path's and
     logits within 1e-4, the exact path ``forward`` over the prompt and
     the generated tokens (gemma3's prompt of 520 tokens, past its
     window: the ring buffers wrap) or, for whisper, whose forward attends
     to encoder memory that decode never sees, the exact decode;
   * the serving stack (``repro_torch.serve`` and ``repro_torch.obs``):
     three ``Server``s, each under a live ``Tracer``, a ``FlightRecorder``,
     a 1 s rollup and ``default_objectives()``: kNN over all 2.3 M points
     and CF over all 48,019 users (one servable each, sharing one
     ``AggregateStore``; pyramids of 1,048,576 and 16,384 base buckets;
     ``BudgetPolicy`` at the jobs' ratio and eps, floors 0.005 and 0.01;
     ``ContinuousBatcher(max_batch=64)``), and qwen3-8b in the flat layout
     on the LM phase's weights (``LMServable``, 16-token prompts, 4 tokens,
     eps_max 0.25, pad sizes 1 and 2).  kNN and CF: ``calibrate`` (its
     probe batch the probe row in all 64 rows, each pass timed with its
     padding, unpacking and error bounds under a scratch tracer, and the
     batch's own host work outside its runs, its spans, grant, cache
     lookup and accuracy proxy, fitted into ``c_fixed``: every class's
     deadline holds that host time), ``ema = 0``, ``prewarm`` at every pad
     size, ``reset_metrics``; SLO classes from the fitted model
     (relaxed 1.5 x ``deadline_for(eps_max)``, tight 1.15 x
     ``deadline_for`` at the grid value below eps_max, 0.005 / 0.04 / 0.16,
     kNN's hopeless 0.25 x ``deadline_for(0)``, each raised to 10 % above
     a power of two where it lay closer, so that a wave stays in one of
     the batcher's log2 SLO classes); four waves of 64 requests
     a class drawn from the test queries (CF: the active users), a kNN wave
     with a loose ``max_error``, a wave under ``install_kernel_probe`` and
     one held against a direct ``run`` with its kernel calls captured; the
     LM calibrated at batch 1 and sent a relaxed wave (its kernel calls
     captured, cloned) and a tight wave of 2 prompts; the kNN pyramid saved
     and a fresh server warm-started from it; a ``FrontDoor`` with tenants ``a``
     (unlimited) and ``b`` (20/s, burst 4), 32 requests each, through its
     worker thread.  Checked: one terminal answer a request, each with its
     stage-1 answer; a batch's answers the bits of a direct ``run`` at the
     granted budget; relaxed eps at least tight eps; no kNN or CF relaxed
     batch escalated, and every kNN one granted eps_max; kNN's hopeless
     requests escalated and re-executed; the loose wave skipped stage 2; no
     cache miss after ``prewarm``; the warm start's first request a hit on
     restored levels with the saved server's bits; ``b``'s excess refused
     with ``Overloaded`` and a ``retry_after_s`` above 0; the metrics
     snapshot, trace and flight exports valid, every escalated batch kept;
     the probe's calls per op equal to the launches; ``calibrate``'s
     stage-1 time at least the CUDA-event time of its own runs; nine
     kernels launched (all but ``agg_refine_attention``).  Per class it
     prints, besides the latencies and grants, each batch's host time
     outside its servable runs (from the spans) and its span over the
     grant's predicted time;
   * the runtime (``repro_torch.runtime``), after the serve phase:
     ``sharded_knn`` splits the kNN data, whole, into 8 failure domains
     (one generator seed a domain) over one ``AggregateStore`` at ratio
     100, k 5, eps 0.01, behind a ``Server`` whose grants are eps_max and
     whose 5 s deadline leaves a hedge its room; 12 waves of 64 test
     queries through a ``ChaosInjector`` schedule: domain 3 killed at a
     stage 1 (two partial waves, then restored from the snapshot saved
     after the first wave), domain 5 slowed 8x in a stage 2, domain 3
     killed again and its snapshot marked corrupt (rebuilt).  Checked:
     one terminal answer a request; ``partial_shards`` (3,) on each batch
     while domain 3 is dead and () otherwise; every run's merged output
     (distances, labels, votes, bounds) the bits of ``merge_topk`` and
     ``majority_vote`` over its live domains' direct ``KNNServable.run``
     at the same budget, so the recovered waves have the full fleet's
     bits; one recovery restored and one rebuilt; the slowed domain
     hedged and the hedge won; each merge one ``candidate_topk`` launch;
     five kernels launched.  It prints the batch p50 healthy, partial,
     hedged and recovering, the recoveries, hedges and the snapshot's
     save and restore ms;
   * the mesh path (``launch/mesh.py``, ``parallel/``), after the fleet
     phase: ``run_ranks`` starts 8 ranks on the one card, joined by gloo
     (NCCL puts no two ranks of a communicator on one device), on CUDA
     tensors (``parallel/collectives.py``'s table; the pipeline's hops
     staged through pinned host buffers); the parent makes the data once
     and shares it through host memory, each rank copying its own shard to
     the card.  kNN: the 2.3 M points in 8 map shards of 287,500 x 217 on
     a (8,) data mesh, each map building its shard's aggregates from the
     kNN phase's draw at compression 100 and running ``accurateml_map``
     with its bound at eps 0 and 0.01; ``MapReduce(mesh)`` all-gathers,
     ``merge_topk`` and ``majority_vote`` (checked: the labels of
     ``run_accurateml(..., n_shards=8)`` on the same draws, the merged
     top-k the bits of ``MapReduce(mesh=None)`` over the 8 stacked shards,
     the same shuffle bytes).  CF: one ``accurateml_map`` with-bound batch
     over the first 48,016 users (48,019 does not divide by 8: 3 users
     cut), 8 shards of 6,002 x 17,700, 1024 active users, eps 0.05, psum
     (num, den, varsum within 2e-4 of the 8 single-device shards summed).
     All eight kNN and CF kernels must launch on every rank.  One MoE layer
     of moonshot-v1-16b-a3b at its published widths (d_model 2,048, 64
     experts of 1,408, top-6, 2 shared; f32, no drops) on a (2, 4) data x
     model mesh through ``_moe_ep_sharded``: ``moe_ep``, ``moe_ep_a2a``
     (bf16 buffers) and the decode arm at B 1, against ``moe_dense`` on
     one rank within 2e-4 (2e-2 for the a2a buffers).  Two 4-stage
     ``pipeline_apply`` GPipe pipelines of ``tanh(x @ w)`` at d 4,096 with
     8 microbatches, forward and gradient against ``sequential_reference``
     within 1e-4.  Four steps of qwen3-8b at the smoke widths on (2, 4)
     (parameters placed by ``param_shardings``) against the single-rank
     step within 1e-5 (``tests/test_torch_train.py``'s rounding rule), one
     checkpoint saved from that placement and restored onto a (2, 2) mesh
     of 4 ranks with ``shardings=`` (``param_shardings`` there), the same
     bits.  It prints each job's time (the
     slowest rank's), the peak memory a rank, the card's name and power
     limit: 8 ranks time-sliced on one card, no multi-GPU figure;
   * the eight examples (the examples phase, after the mesh phase): each
     ``examples/torch_<name>.py`` by its ``main`` in this process on the
     card at its defaults (the JAX package's examples' sizes;
     ``torch_train_lm`` at 30 steps, the supervisor phase's cut), its
     launches counted alone: each returns 0 with its own checks passing
     and launches exactly the kernels of its ``EXAMPLES`` row (all eight
     kNN and CF kernels for quickstart, serve_aggregated and
     observe_serving, the four CF ones for cf_recommend, ``lsh_hash`` for
     store_pyramid, the five kNN ones for chaos_serving,
     ``distance_topk`` and ``agg_refine_attention`` for serve_lm_decode,
     none for train_lm); their launches join the kernels line, and each
     first call of every shape they give a kernel, the example's name in
     its key, is held against its plain version with the others (step 3).
     It prints each example's seconds and launches;
   * training, after the kernels are held (it runs none of them): qwen3-8b
     at its published widths, 2 layers deep (1.63 B parameters, bf16
     weights, f32 AdamW moments), ``make_train_step`` on 6
     ``TokenPipeline`` batches of 1 x 2,048 tokens (the blockwise
     attention path), then 4 steps on one batch: finite losses, the
     repeated batch's falling; ``blockwise_sdpa``'s output and dq, dk, dv
     at [1, 2048, 8, 4, 128] in f32, causal and with a 512 window, within
     1e-4 (relative to each tensor's largest entry) of autograd through
     the plain ``_sdpa``.  It prints step p50, tokens/s, peak memory;
   * the supervisor: ``examples/train_lm.py``'s default model (d_model
     256, 8 layers, f32) trained 30 steps under ``Supervisor`` (saves
     every 10, a straggler at 5, a node failure at 25), plain and with
     ``compress_topk`` at 0.01, each beside an uninterrupted run: one
     restart, steps 20-24 re-executed with the same losses to the bit,
     the final state the uninterrupted run's bits, an async save that
     restores what it saved, a manifest that lists every leaf.  It
     prints checkpoint bytes, save and restore ms;
   * the dry run (the dryrun phase, last): ``launch/dryrun.py``'s
     ``run_all`` over all 80 cells (10 archs x 4 shapes x the 16 x 16 and
     2 x 16 x 16 meshes; no files), then one device's blocks of every
     argument of each cell's step allocated on the card, a cell at a
     time (``allocate_on_card``; no kernel runs): each fits, and nothing
     is left allocated after it.  Then the stand-ins against the tensors
     the port allocates: for each arch at its published widths and a cut
     depth (``cut_depth``: each kind of block kept), the train_4k,
     decode_32k and long_500k cells' parameters, AdamW state and caches
     built on the card (``build_cell``: ``init_params``,
     ``optim.init_state``, ``init_caches``; at most 2 sequences), each
     leaf's shape and dtype and each group's storage bytes equal to
     ``cell_leaves``' on a mesh of one device (``compare_build``).  It
     prints the cells, the largest cell's GiB a device, the bytes built
     and the phase's seconds;
3. holds each kernel against its plain PyTorch version (``kernels/ref.py``)
   on the very inputs the paths gave it, at every shape it was called with
   (the serve phase's: one batch of each kNN and CF wave held against a
   direct run, and the LM server's relaxed wave: the first call of each
   shape, prefill at B 1 and decode at B 2 at rf 0 and 0.25, with 64
   buckets over 1024 slots of which a few hold tokens; the moe and arch
   phases' head shapes, each model, layout and level; the examples'
   shapes, which are checked and not timed),
   and times kernel, plain version and, where one PyTorch call computes the
   same function, that call (``library_ms``); ``distance_topk`` at each of
   its shapes: the kNN shapes (wide regime) and the LM's batched ones (B 4
   at k 4, 16 and 64, B 1 at k 64).  Each time is read twice in alternate
   runs: with the card given a head start (its time alone: ``ms``,
   ``plain_ms``, ``library_ms``) and without one (the host's gaps
   included, as on the path: ``no_head_start``);
4. checks the end-to-end answers of the three paths on a small input
   against the same functions run on the CPU, and that aggregation gives
   identical bits on two runs;
5. prints the accuracies and RMSEs, a JSON line a phase (the fleet,
   mesh, examples, train, supervisor and dryrun lines with the card's
   name and power limit), one
   JSON line ``{"kernels": [...]}``, the card's name and power limit from
   nvidia-smi, and as its last line ``{"ok": true, "device": {...}}``.

Tolerances: kNN distances agree within rtol 1e-4 plus atol 1e-4 (fp32 sums
in another order; the JAX package's own kernel tests use the same).  Labels
agree exactly except at near-ties: a slot whose plain distance has a
neighbour in the plain ranking (the (k+1)-th included) within that
tolerance; each one is counted and the first few are named.  CF weights and
sums agree within rtol 2e-4 plus atol 2e-4, the JAX package's CF kernel
tolerance; CF's bucket statistics (``cf_aggregate``) equal the plain
version's bits (the same products, each sum in the same order).  LSH hashes may differ by one on under 0.1 % of entries, where a
projection lies on a bucket border (the JAX package's own rule); bucket ids
agree on every row whose hashes all agree, and under 0.1 % of rows have a
flipped hash.  The full-scale CF answers: under 0.1 % of the predictions
more than half a star outside [1, 5]; every RMSE at least the ratings'
noise (0.5) and below that of predicting each user's mean; the approximate
jobs' RMSE loss under 6 %.
The decode-attention kernels agree with their plain versions within rtol
2e-5 plus atol 2e-5 (the JAX package's attention tolerance), in f32 on the
same cache values, bf16 or f32; the LM's tokens on the card equal those on
the CPU and its logits agree within 2e-5 (smoke config, f32, 6 decode steps
at every refine_frac of the LM sweep), as do the arch phase's five smoke
configs', each with one forward (whisper with frames, qwen2-vl with an
M-RoPE grid whose three rows differ).

It exits non-zero, printing no result, when there is no CUDA device, when
the package is not beside it, or when any check fails.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path
from typing import NamedTuple

N_TRAIN = 2_300_000   # mfeat-factors: 2.3 M points (src/repro/data/synthetic.py)
N_FEATURES = 217
N_CLASSES = 10
N_QUERY = 1024
K = 5
N_SHARDS = 8
RATIO = 100.0
EPS_LEVELS = (0.0, 0.01)
SAMPLE_FRAC = 0.1
RTOL = ATOL = 1e-4

# The Netflix subset of src/repro/data/synthetic.py:10-13, generated by
# make_netflix_like with its other defaults; the first CF_ACTIVE users are
# the active users (train ratings in, held-out ratings for RMSE).
CF_USERS = 48_019
CF_ACTIVE = 1024
CF_ITEMS = 17_700
CF_DENSITY = 0.012
CF_RATIO = 20.0       # examples/cf_recommend.py:35, tests/test_apps.py:108
CF_EPS_LEVELS = (0.0, 0.05)
CF_SAMPLE_FRAC = 1.0 / CF_RATIO + 0.05   # equal work, tests/test_apps.py:125
CF_TOL = 2e-4         # tests/test_kernels.py:63,317
CF_CHECK_QUERIES = 128  # the plain cf_refine gathers [Q, B, I]: 21.8 GB per
                        # tensor at the full batch, so it runs in slices
# Two buckets whose stage-1 weights lie this close can swap ranks between
# the card and the CPU (fp32 sums in another order; the weights differ by
# about 1e-6), and so change which users a query refines.
RANK_TIE_TOL = 1e-5
# A prediction more than half a star (the rounding of the 1..5 scale) outside
# [1, 5] is that far from any rating; on this data under 1e-3 of them are.
PRED_SLACK = 0.5
PRED_OUT_SHARE = 1e-3
# The ratings' noise (make_netflix_like: 0.5 stars) is a floor no job's RMSE
# reaches without the held-out ratings; every job must beat each user's mean
# rating; and AccurateML's and the sampled job's loss against exact stays
# under the reference's 6 % (tests/test_apps.py:102-112).
RMSE_FLOOR = 0.5
RMSE_LOSS_MAX = 0.06

# The aggregate store phase: one servable per shard of each job, sharing one
# AggregateStore per job, each pyramid PyramidSpec.for_points(shard) (kNN:
# 131,072 base buckets over 9 levels; CF: 2,048).  The first ratio is built,
# the next merged; the merged levels are held against cold builds at two
# ratios each.  StreamingAggregate re-ingests kNN shard 0 in STREAM_BATCHES
# uneven appends of chunks of STREAM_CHUNK rows.  At a full budget
# (EXACT_QUERIES of shard 0's queries, [128, 287,500] refine slots, well
# under refine_distances' int32 limit) the store-backed answer is exact kNN.
STORE_RATIOS = (100.0, 400.0, 25.0)
CF_STORE_RATIOS = (20.0, 80.0, 40.0)
STORE_SEED = 30
STREAM_CHUNK = 4096
STREAM_BATCHES = 16
EXACT_QUERIES = 128

# Aggregated-KV LM decode: qwen3-8b at full width and depth in bf16,
# benchmarks/decode_bench.py's sweep, served by DecodeEngine with four slots.
LM_ARCH = "qwen3-8b"
LM_SLOTS = 4
LM_S_MAX = 1024
LM_COMPRESSION = 16           # K = 64 buckets of 2 x 16 = 32 slots each
LM_PROMPT = 128           # cut from 256: host-bound prefill (PERF.md)
LM_NEW_TOKENS = 32            # the prefix's token, then 31 decode steps
LM_SWEEP = (0.0, 0.05, 0.25, 1.0)
LM_LAYOUTS = ("bucket_major", "flat")
LM_WARM_STEPS = 2             # untimed steps at each level first
LM_GUARD_LAYERS = 2           # the f32 exactness guard's depth
LM_GUARD_TOL = 1e-4           # benchmarks/decode_bench.py:130
ATTN_TOL = 2e-5               # tests/test_kernels.py:108
LM_CPU_TOL = 2e-5             # card vs CPU, smoke config, f32

# MoE and MLA decode (the moe phase) and the other five model families (the
# arch phase): each model of DECODE_MODELS at its published widths and the
# depth named (the first_k_dense head block of the MoE models dense, the
# rest MoE), bf16, random from seed 0, served by DecodeEngine as the LM
# phase serves qwen3-8b (LM_SLOTS slots, LM_S_MAX, LM_COMPRESSION) in the
# layouts named: ``prompt``-token prompts prefilled (cut from the LM
# phase's: a prefill token is host-bound), one untimed step, then
# DECODE_STEPS steps at each refine_frac of DECODE_SWEEP, or at 1.0 alone
# for a model without aggregated layers (xLSTM), where every level runs the
# same work.  zamba2-7b is cut from 81 layers to 15: two units of five
# Mamba2 blocks and the shared attention, then the three-Mamba2 tail.
# Then the row's f32 guard, if it has one: the model at its published
# widths, cut as ``guard`` says, ``guard_prompts`` prompts of
# ``guard_prompt`` tokens and DECODE_GUARD_NEW tokens each, at rf 1.0 the
# engine's tokens equal the exact path's and its logits agree within
# LM_GUARD_TOL.  The exact path (``exact``) is ``forward`` over the prompt
# and the generated tokens, or a batch-1 exact decode (agg_kv off): for MLA
# (``mla_decode`` over the latent cache; deepseek-v2-236b without capacity
# drops, tests/test_models.py:48's no-drop variant: a batch of two routes
# other tokens than the batch-1 decode) and for whisper, whose forward
# attends to encoder memory that decode never sees.  Each guard is one
# pattern unit deep, but xLSTM's: one mLSTM and one sLSTM block, since f32
# rounding at its 8-block unit drifts past LM_GUARD_TOL between any two
# orders of the same sums, the card's forward against the CPU's among them
# (tools/torch_f32_drift.py, PERF.md).  gemma3's guard prompt runs past its
# 512-token window, so its ring buffers wrap; the others' 57 tokens make
# the forward 64 tokens long (zamba2's SSD chunk).
class DecodeModel(NamedTuple):
    phase: str                    # "moe" or "arch"
    arch: str
    n_layers: int                 # the depth served
    layouts: tuple
    prompt: int                   # tokens a prompt on the path
    guard: dict | None            # the f32 guard's cut; None: no guard
    guard_prompts: int = 1
    guard_prompt: int = 57
    exact: str = "forward"        # the guard's exact path: or "decode"


MOE_NO_DROP = 100.0           # capacity_factor: every chosen expert keeps
                              # every token (tests/test_models.py:48)
DECODE_MODELS = (
    DecodeModel("moe", "deepseek-v2-236b", 3, LM_LAYOUTS, 128,
                {"n_layers": 2, "capacity_factor": MOE_NO_DROP},
                guard_prompts=2, guard_prompt=32, exact="decode"),
    DecodeModel("moe", "moonshot-v1-16b-a3b", 4, ("flat",), 128, None),
    DecodeModel("arch", "zamba2-7b", 15, LM_LAYOUTS, 64, {"n_layers": 6}),
    DecodeModel("arch", "gemma3-1b", 26, LM_LAYOUTS, 64, {"n_layers": 6},
                guard_prompt=520),
    DecodeModel("arch", "qwen2-vl-2b", 28, ("flat",), 64, {"n_layers": 2}),
    DecodeModel("arch", "whisper-tiny", 4, ("flat",), 64,
                {"n_layers": 2, "n_encoder_layers": 2}, exact="decode"),
    DecodeModel("arch", "xlstm-350m", 24, ("flat",), 64,
                {"n_layers": 2, "pattern": ("mlstm", "slstm")}),
)
DECODE_SWEEP = (0.0, 0.25, 1.0)
DECODE_STEPS = 6
DECODE_GUARD_NEW = 8

# The serving stack: three servers, each over one servable that holds a
# whole dataset (the deployment of one card): kNN over all N_TRAIN points
# and CF over all CF_USERS users, sharing one AggregateStore, and qwen3-8b
# (the LM phase's weights, flat layout).  Policies: the jobs' ratios and
# eps; the LM's eps_max 0.25 gives refined budgets of 1 to 16 of its 64
# buckets.  Traffic per kind in waves of SERVE_BATCH requests per SLO class,
# the classes derived from the fitted cost model: relaxed 1.5 x
# deadline_for(eps_max), tight 1.15 x deadline_for(the grid value below
# eps_max), hopeless 0.25 x deadline_for(0) (kNN only; CF has none, as
# benchmarks/serve_latency.py:34).
SERVE_BATCH = 64
SERVE_WAVES = 4
SERVE_SEED = 40
SERVE_POLICY = {
    "knn": dict(compression_ratio=RATIO, eps_max=0.01, degrade_floor=0.005),
    "cf": dict(compression_ratio=CF_RATIO, eps_max=0.05, degrade_floor=0.01),
    "lm": dict(eps_max=0.25, degrade_floor=0.04),
}
SERVE_CLASSES = {"knn": ("relaxed", "tight", "hopeless"),
                 "cf": ("relaxed", "tight"), "lm": ("relaxed", "tight")}
# The relaxed class never escalates, and in these kinds keeps eps_max in
# every batch.  CF's may be cut below it: its stage 2 costs nearly as much
# at eps 0.02 as at 0.05, so the tight class's batches, granted less, run
# well over their linear prediction and raise the load correction that the
# kind's classes share (PERF.md, PR 20).
SERVE_KEEPS_EPS_MAX = ("knn",)
SERVE_LOOSE_ERROR = 1.0       # kNN bounds lie in [0, 1]: every one meets it
# A class's deadline lies at least this share above a power of two (the
# batcher's SLO classes are log2 ones): a wave of SERVE_BATCH takes some
# 0.3 ms to submit, a tenth of a relaxed kNN deadline's class.
SLO_CLASS_MARGIN = 0.1
LM_SERVE_PROMPT = 16
LM_SERVE_NEW = 4
LM_SERVE_SLOTS = 2
DOOR_BURST = 32               # requests a tenant sends through the front door
DOOR_B = dict(rate=20.0, burst=4.0)

# The runtime (fleet phase): the kNN data, whole, in N_SHARDS failure
# domains over one AggregateStore, at the jobs' ratio, k and eps 0.01,
# behind a Server; each wave one batch of FLEET_BATCH test queries (stage 1
# and stage 2: two runs).  A killed shard recovers FLEET_RECOVERY_RUNS runs
# (two waves) later; the slowed shard runs FLEET_SLOW_FACTOR times slower.
FLEET_BATCH = 64
FLEET_DEADLINE_S = 5.0
FLEET_SEED = 50
FLEET_KILLED = 3
FLEET_SLOWED = 5
FLEET_SLOW_FACTOR = 8.0
FLEET_MAX_STALL_S = 1.0       # the slowed run takes its whole 8x (the
                              # runtime's default caps a stall at 50 ms)
FLEET_RECOVERY_RUNS = 4
FLEET_PLAN = ("warm", "healthy", "healthy", "kill", "partial", "restored",
              "slow", "kill", "partial", "rebuilt", "healthy", "healthy")
FLEET_KERNELS = ("distance_topk", "candidate_topk", "knn_distance",
                 "refine_distances", "lsh_hash")
# The training path (train phase): qwen3-8b at its published widths, depth
# cut from 36 to TRAIN_LAYERS (1.63 B parameters: bf16 weights and grads
# and f32 moments take 19.6 GB; 36 layers would not fit one card), one
# sequence of TRAIN_SEQ tokens a step (the blockwise attention path).
TRAIN_LAYERS = 2
TRAIN_SEQ = 2048
TRAIN_STEPS = 6
TRAIN_REPEAT = 4
TRAIN_LR = 3e-4
BLOCKWISE_SHAPE = (1, 2048, 8, 4, 128)   # [B, S, Hkv, G, hd], f32
BLOCKWISE_WINDOW = 512
BLOCKWISE_TOL = 1e-4          # relative to each tensor's largest entry
# The supervisor phase: examples/train_lm.py's default model and batch
# (8 x 128 tokens), its run cut to SUP_STEPS steps.
SUP_STEPS = 30
SUP_SAVE_EVERY = 10
SUP_STRAGGLER = 5
SUP_FAILURE = 25
SUP_COMPRESS = 0.01
SUP_BATCH = 8
SUP_SEQ = 128

KNN_KERNELS = ("distance_topk", "candidate_topk", "knn_distance",
               "refine_distances", "lsh_hash")
CF_KERNELS = ("cf_weights", "cf_refine", "cf_aggregate", "lsh_hash")
LSH_KERNELS = ("lsh_hash",)
STORE_KERNELS = ("lsh_hash", "distance_topk", "knn_distance",
                 "refine_distances", "candidate_topk", "cf_weights",
                 "cf_refine", "cf_aggregate")
LM_KERNELS = {"bucket_major": ("distance_topk", "agg_refine_attention"),
              "flat": ("distance_topk", "aggregated_attention_decode")}
ATTN_KERNELS = ("agg_refine_attention", "aggregated_attention_decode")
SERVE_KERNELS = STORE_KERNELS + ("aggregated_attention_decode",)

# Published peaks of one H100 SXM (NVIDIA data sheet): fp32 on the CUDA
# cores and HBM3 bandwidth, both at the full 700 W power limit.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Cycles the card spins before each timed run: about 2.5 ms at the H100's
# 1.98 GHz, longer than the host takes to enqueue any timed call.
HEAD_START_CYCLES = 5_000_000

REPLACES = {
    "distance_topk": "src/repro/kernels/distance_topk.py:84",
    "candidate_topk": "src/repro/kernels/topk_stream.py:118",
    "knn_distance": "src/repro/kernels/knn_distance.py:51",
    "refine_distances": "src/repro/kernels/refine_distances.py:66",
    "lsh_hash": "src/repro/kernels/lsh_hash.py:50",
    "cf_weights": "src/repro/kernels/cf_weights.py:70",
    "cf_refine": "src/repro/kernels/cf_refine.py:115",
    "cf_aggregate": "none: src/repro/apps/cf.py leaves these segment sums "
                    "to XLA",
    "agg_refine_attention": "src/repro/kernels/agg_refine.py:132",
    "aggregated_attention_decode":
        "src/repro/kernels/aggregated_attention.py:94",
}
SOURCES = {"agg_refine_attention": "agg_refine",
           "aggregated_attention_decode": "aggregated_attention"}
def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# capturing the main path's kernel inputs
# ---------------------------------------------------------------------------

class CaptureProbe:
    """An ops probe that keeps one call of each op at each distinct set of
    argument shapes, and otherwise just forwards the call: the first, or
    with ``skip`` set the first after ``skip`` calls of the same key.  With
    ``clone`` it keeps copies of the tensors, for callers that update their
    inputs in place afterwards (the decode caches)."""

    def __init__(self, torch, clone: bool = False):
        self.torch = torch
        self.clone = clone
        self.tag = None       # set by the caller: part of every key
        self.skip = 0         # set by the caller: calls of a key to pass by
        self.seen: dict[tuple, int] = {}
        self.calls: dict[str, dict] = {}

    def _sig(self, a):
        return tuple(a.shape) if isinstance(a, self.torch.Tensor) else a

    def _keep(self, a):
        return a.clone() if isinstance(a, self.torch.Tensor) else a

    def timed(self, op, fn, args, kwargs):
        key = (self.tag,) + tuple(self._sig(a) for a in args) + tuple(
            sorted((k, self._sig(v)) for k, v in kwargs.items())
        )
        calls = self.calls.setdefault(op, {})
        n_seen = self.seen.get((op, key), 0)
        self.seen[(op, key)] = n_seen + 1
        if key not in calls and n_seen >= self.skip:
            calls[key] = ((tuple(self._keep(a) for a in args),
                           {k: self._keep(v) for k, v in kwargs.items()})
                          if self.clone else (args, kwargs))
        return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def bench_ms(torch, fn, flush) -> tuple[float, float]:
    """Median CUDA-event times of fn(), the L2 cache flushed before each run
    (the main path finds its large inputs cold), with and without a head
    start, in alternate runs.  With it the card spins HEAD_START_CYCLES
    before the start event, so that the host has enqueued all of fn()
    before the card reaches it: the card's time alone.  Without it a host
    slower than the card (30-100 µs of Python around some 10 µs of card
    time) counts too, as it does on the main path."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    first = start.elapsed_time(end)
    reps = max(3, min(20, int(2000.0 / max(first, 1e-3))))
    times = {True: [], False: []}
    for _ in range(reps):
        for head_start in (True, False):
            flush.zero_()
            if head_start:
                torch.cuda._sleep(HEAD_START_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[head_start].append(start.elapsed_time(end))
    return statistics.median(times[True]), statistics.median(times[False])


def work(torch, op, args, kwargs):
    """(flops, bytes) the op must do and move on these inputs: each input
    read once, each output written once; data-dependent work counted on
    these inputs."""
    k = kwargs.get("k")
    if op == "distance_topk":
        # 2-D, or batched ([B,Q,D] x [B,N,D]): only the valid points' rows
        # need to be read and scored
        q, p, labels = args[:3]
        valid = args[3] if len(args) > 3 else kwargs.get("valid")
        nq, d = q.shape[-2:]
        b, n = (q.shape[0] if q.dim() == 3 else 1), p.shape[-2]
        live = b * n if valid is None else int(valid.expand(b, n).sum())
        nbytes = 4 * (b * nq * d + live * d + labels.numel()) + (
            valid.numel() if valid is not None else 0)
        return 2.0 * nq * live * d, nbytes + 8 * b * nq * k
    if op == "candidate_topk":
        # [Q,M], or a [P,Q,M] stack read as [Q, P M]: every value read
        # once, a label only for each of the k winners (from the seed or
        # the candidates); an unseeded slot past the candidates reads none
        dists = args[0]
        nq = dists.shape[-2]
        m = dists.numel() // max(nq, 1)
        seeded = len(args) > 2 and args[2] is not None
        cols = m + (k if seeded else 0)
        return 0.0, 4 * nq * cols + 4 * nq * min(k, cols) + 8 * nq * k
    if op == "knn_distance":
        q, p = args
        nq, d = q.shape
        n = p.shape[0]
        return 2.0 * nq * n * d, 4 * (nq * d + n * d + nq * n)
    if op == "refine_distances":
        # the bucket of each row only schedules the kernel: not counted
        q, x, idx, valid = args[:4]
        nq, d = q.shape
        nb = idx.shape[1]
        n_valid = int(valid.sum())
        rows = int(torch.unique(idx[valid]).numel())
        return (4.0 * n_valid * d,
                4 * nq * d + 4 * rows * d + 4 * nq * nb + nq * nb + 4 * nq * nb)
    if op == "lsh_hash":
        # the ids epilogue (a ``base`` given) writes one id a row, the raw
        # one H hashes
        x, a = args[:2]
        n, d = x.shape
        h = a.shape[1]
        out = n if "base" in kwargs else n * h
        return 2.0 * n * d * h, 4 * (n * d + d * h + h + out)
    if op == "cf_weights":
        # only co-rated items add anything (every term carries both masks):
        # three multiply-adds per co-rated (q, u, item) triple, the squares
        # once per rated entry of either side
        a, am, u, um = args
        nq, ni = a.shape
        nu = u.shape[0]
        a_nz, u_nz = am != 0, um != 0
        co = float((a_nz.sum(0, dtype=torch.float64)
                    * u_nz.sum(0, dtype=torch.float64)).sum())
        return (6.0 * co + int(a_nz.sum()) + int(u_nz.sum()),
                4 * (2 * nq * ni + 2 * nu * ni + nq * nu))
    if op == "cf_refine":
        # per used slot: four multiply-adds for the four sums over the items
        # the query and the selected user both rated (8 operations each),
        # two for the accumulations over the items the selected user rated
        # (4 each).  Each distinct used row read once; w written once.
        a, am, _, m, idx, use = args
        nq, ni = a.shape
        nb = idx.shape[1]
        rows = idx.long().clamp(0, m.shape[0] - 1)
        m_nz = (m != 0).to(torch.float32)
        co = ((am != 0).to(torch.float32) @ m_nz.T).gather(1, rows)
        rated = m_nz.sum(1)[rows]
        n_rows = int(torch.unique(rows[use]).numel())
        return (float((8.0 * co + 4.0 * rated)[use].sum(dtype=torch.float64)),
                4 * 4 * nq * ni + 8 * n_rows * ni + 9 * nq * nb)
    if op == "cf_aggregate":
        # ratings and mask read once, the means, order and offsets once,
        # the four [K, I] sums written once; per user and item three
        # products, a difference and four sums (8 operations)
        r, _, _, order, offsets = args
        nu, ni = r.shape
        k = offsets.shape[0] - 1
        return 8.0 * nu * ni, 4 * (2 * nu * ni + 2 * nu + k + 1 + 4 * k * ni)
    if op == "agg_refine_attention":
        # the live rows of the selected buckets: each distinct (sequence,
        # bucket) read once, every selection slot computed (2 G (dk + dv)
        # operations per row and KV head)
        q, ks, vs, counts, top_idx, use = args
        b, hkv, g, dk = q.shape
        cap, dv = ks.shape[2], vs.shape[-1]
        cnt = counts.gather(1, top_idx.long())
        n_live = torch.where((use != 0) & (cnt > 0),
                             torch.clamp_max(cnt, cap), 0)
        pair = torch.arange(b, device=q.device)[:, None] * counts.shape[1] \
            + top_idx.long()
        uniq, first = torch.unique(torch.where(n_live > 0, pair, -1),
                                   return_inverse=True)
        rows = int(torch.zeros(uniq.numel(), dtype=torch.long,
                               device=q.device).scatter_reduce(
            0, first.flatten(), n_live.flatten().long(), "amax").sum())
        item = ks.element_size()
        return (2.0 * g * (dk + dv) * hkv * int(n_live.sum()),
                4 * b * hkv * g * dk + rows * hkv * (dk + dv) * item
                + 9 * top_idx.numel() + 4 * b * hkv * g * (2 + dv))
    if op == "aggregated_attention_decode":
        # bucket_of below valid_len, the live tokens' K/V rows, the live
        # centroids, counts and refined: each read once
        q, kc, vc, bucket_of, mk, mv, counts, refined = args
        vl = kwargs["valid_len"]
        b, hq, dk = q.shape
        s, hkv, dv = kc.shape[1], kc.shape[2], vc.shape[-1]
        t = torch.arange(s, device=q.device)[None, :]
        live_tok = int((refined.gather(1, bucket_of.long())
                        & (t < vl[:, None].long())).sum())
        live_cent = int((~refined & (counts > 0)).sum())
        item = kc.element_size()
        return (2.0 * (hq // hkv) * (dk + dv) * hkv * (live_tok + live_cent),
                4 * b * hq * dk + 4 * int(vl.clamp_max(s).sum())
                + live_tok * hkv * (dk + dv) * item
                + live_cent * hkv * (dk + dv) * 4 + 5 * refined.numel()
                + 4 * b + 4 * b * hq * dv)
    raise ValueError(op)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def compare_topk(torch, big, got_d, got_l, want_d, want_l, next_d):
    """Kernel (got) vs plain (want) top-k.  ``next_d`` is the plain
    ranking's (k+1)-th distance per row, for the near-tie test.  Returns
    (max_abs_err, mismatches, near_ties, examples, tie_rows)."""
    got_pad = got_d >= big / 2
    want_pad = want_d >= big / 2
    if not torch.equal(got_pad, want_pad):
        fail(f"padding slots differ at {int((got_pad != want_pad).sum())} "
             "places")
    real = ~want_pad
    err = (got_d - want_d).abs()
    max_err = float(err[real].max()) if bool(real.any()) else 0.0
    tol = ATOL + RTOL * want_d.abs()
    if bool((err > tol)[real].any()):
        bad = int((err > tol)[real].sum())
        fail(f"{bad} distances beyond tolerance (max err {max_err:.3e})")
    ext = torch.cat([want_d, next_d[:, None]], dim=1)
    close = ((ext[:, 1:] - ext[:, :-1]).abs()
             <= ATOL + RTOL * ext[:, 1:].abs())          # [Q, k]
    tie = torch.zeros_like(real)
    tie[:, 1:] |= close[:, :-1]      # ties with the slot before
    tie |= close                     # ties with the slot after
    mism = real & (got_l != want_l)
    unexplained = mism & ~tie
    if bool(unexplained.any()):
        q, j = [int(v) for v in unexplained.nonzero()[0]]
        fail(f"{int(unexplained.sum())} label mismatches with no near-tie, "
             f"first at query {q} slot {j}: kernel ({float(got_d[q, j])}, "
             f"{int(got_l[q, j])}) vs plain ({float(want_d[q, j])}, "
             f"{int(want_l[q, j])})")
    examples = [
        f"q{int(q)}/slot{int(j)} d={float(want_d[q, j]):.6g}"
        for q, j in mism.nonzero()[:3]
    ]
    return max_err, int(mism.sum()), int((mism & tie).sum()), examples, \
        mism.any(dim=1)


def cf_refine_slice(args, lo, hi):
    """The cf_refine arguments of queries [lo, hi)."""
    a, am, r, m, idx, use = args
    return (a[lo:hi], am[lo:hi], r, m, idx[lo:hi], use[lo:hi])


def kernel_fns(ops, ref, op, kwargs):
    """(kernel wrapper, plain version) of one captured call: ``lsh_hash``'s
    ids epilogue (a ``base`` given) has its own pair."""
    if op == "lsh_hash" and "base" in kwargs:
        return ops.lsh_bucket_ids_cuda, ref.lsh_bucket_ids
    return ops.KERNELS[op], getattr(ref, op)


def compare_lsh(torch, ref, raw_kernel, args, kwargs, got, want):
    """Hashes (got, want: [N, H]) off by at most 1 on under 0.1 % of
    entries, where a projection lies on a bucket border.  Ids (got, want:
    [N]) equal on every row whose hashes all equal the plain ones, rows
    with a flip under 0.1 %; the hashes of an ids call are the raw
    epilogue's on the same inputs."""
    if got.dim() == 1:
        ids_got, ids_want = got, want
        got, want = raw_kernel(*args), ref.lsh_hash(*args)
        torch.cuda.synchronize()
    diff = (got.long() - want.long()).abs()
    flipped = float((diff > 0).float().mean())
    if int(diff.max()) > 1 or flipped >= 1e-3:
        fail(f"lsh_hash: max diff {int(diff.max())}, {flipped:.2e} of "
             "hashes differ (allowed: 1, under 1e-3)")
    out = {"max_abs_err": float(diff.max()), "flipped_share": flipped,
           "label_mismatch": 0, "near_ties": 0, "near_tie_examples": []}
    if "base" in kwargs:
        rows = (diff > 0).any(dim=1)
        share = float(rows.float().mean())
        off = (ids_got != ids_want) & ~rows
        if bool(off.any()) or share >= 1e-3:
            fail(f"lsh_hash ids: {int(off.sum())} rows differ with equal "
                 f"hashes; {share:.2e} of rows have a flipped hash (allowed: "
                 "none, under 1e-3)")
        out.update(flipped_rows=int(rows.sum()),
                   ids_differ=int((ids_got != ids_want).sum()))
    return out


def check_kernel(torch, ref, topk_stream, ops, op, args, kwargs):
    """Run kernel and plain version on the captured inputs; return the
    comparison summary."""
    big = topk_stream.BIG
    none = {"label_mismatch": 0, "near_ties": 0, "near_tie_examples": []}
    if op == "cf_refine":
        args = cf_refine_slice(args, 0, CF_CHECK_QUERIES)
    wrapper, plain = kernel_fns(ops, ref, op, kwargs)
    got = wrapper(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    if op in ATTN_KERNELS:
        # bf16 caches: the plain version reads the same bf16 values in f32
        outs = (zip(("m", "l", "acc"), got, want)
                if op == "agg_refine_attention" else [("out", got, want)])
        max_err = 0.0
        for name, g, w in outs:
            err = (g - w).abs()
            max_err = max(max_err, float(err.max()) if err.numel() else 0.0)
            if not bool(torch.isfinite(g).all()) or bool(
                    (err > ATTN_TOL + ATTN_TOL * w.abs()).any()):
                fail(f"{op} {name}: beyond tolerance (max err "
                     f"{float(err.max()):.3e})")
        return {"max_abs_err": max_err, **none}
    if op == "lsh_hash":
        return compare_lsh(torch, ref, ops.KERNELS[op], args, kwargs, got,
                           want)
    if op == "cf_aggregate":
        # the same products and the same order of every sum: the same bits
        max_err = 0.0
        for name, g, w in zip(("sr", "sr2", "s", "c"), got, want):
            err = (g - w).abs()
            max_err = max(max_err, float(err.max()) if err.numel() else 0.0)
            if not torch.equal(g, w):
                fail(f"cf_aggregate {name}: {int((g != w).sum())} entries "
                     f"differ from the plain version's bits (max err "
                     f"{max_err:.3e})")
        return {"max_abs_err": max_err, **none}
    if op in CF_KERNELS:
        outs = (zip(("w", "num", "den"), got, want) if op == "cf_refine"
                else [("w", got, want)])
        max_err = 0.0
        for name, g, w in outs:
            err = (g - w).abs()
            max_err = max(max_err, float(err.max()) if err.numel() else 0.0)
            if not bool(torch.isfinite(g).all()) or bool(
                    (err > CF_TOL + CF_TOL * w.abs()).any()):
                fail(f"{op} {name}: beyond tolerance (max err "
                     f"{float(err.max()):.3e})")
        return {"max_abs_err": max_err, **none}
    if op in ("distance_topk", "candidate_topk"):
        k = kwargs["k"]
        ext_d, _ = getattr(ref, op)(*args, **{**kwargs, "k": k + 1})
        rows = (lambda t: t.reshape(-1, t.shape[-1]))   # batched: [B*Q, k]
        err, mism, ties, ex, _ = compare_topk(
            torch, big, rows(got[0]), rows(got[1]), rows(want[0]),
            rows(want[1]), rows(ext_d)[:, k]
        )
        return {"max_abs_err": err, "label_mismatch": mism,
                "near_ties": ties, "near_tie_examples": ex}
    pad_got, pad_want = got >= big / 2, want >= big / 2
    if not torch.equal(pad_got, pad_want):
        fail(f"{op}: BIG slots differ")
    real = ~pad_want
    err = (got - want).abs()
    max_err = float(err[real].max()) if bool(real.any()) else 0.0
    if bool((err > ATOL + RTOL * want.abs())[real].any()):
        fail(f"{op}: distances beyond tolerance (max err {max_err:.3e})")
    return {"max_abs_err": max_err, "label_mismatch": 0, "near_ties": 0,
            "near_tie_examples": []}


def plain_call(ops, ref, op, args, kwargs):
    """The plain version on the captured inputs, as one timed function.
    The plain cf_refine runs in slices of CF_CHECK_QUERIES queries, the most
    whose [Q, B, I] gathers fit beside the path's data."""
    plain = kernel_fns(ops, ref, op, kwargs)[1]
    if op != "cf_refine":
        return lambda: plain(*args, **kwargs)
    nq = args[0].shape[0]
    return lambda: [plain(*cf_refine_slice(args, lo, lo + CF_CHECK_QUERIES),
                          **kwargs)
                    for lo in range(0, nq, CF_CHECK_QUERIES)]


def library_call(torch, op, args, kwargs):
    """One PyTorch call computing the same function, where there is one.
    Timed as a yardstick only; the port never calls it.  None for
    distance_topk, refine_distances, lsh_hash (a product, then a floor),
    cf_weights (three masked products), cf_refine (a gather, then
    reductions), cf_aggregate (products, gathers and segment_reduce: the
    torch chain it replaces, which its plain version is) and
    agg_refine_attention (a gather, then a softmax over the selected
    rows)."""
    if op == "knn_distance":
        q, p = args
        return lambda: torch.cdist(q, p)
    if op == "candidate_topk":
        dists = args[0]
        cat = (dists.permute(1, 0, 2).reshape(dists.shape[1], -1)
               if dists.dim() == 3 else dists)
        if len(args) > 2 and args[2] is not None:
            cat = torch.cat([args[2], cat], dim=1)
        return lambda: torch.topk(cat, kwargs["k"], dim=1, largest=False)
    if op == "aggregated_attention_decode":
        return sdpa_call(torch, args, kwargs)
    return None


def sdpa_call(torch, args, kwargs):
    """One scaled_dot_product_attention over [tokens; centroids] with the
    two-stage biases as its mask: 0 for a live token, log(count) for a live
    centroid, NEG for the rest.  Its inputs are made here, outside the
    timed call; the G query heads of a KV head are its query rows."""
    q, kc, vc, bucket_of, mk, mv, counts, refined = args
    vl = kwargs["valid_len"]
    b, hq, dk = q.shape
    s, hkv = kc.shape[1], kc.shape[2]
    neg = -1.0e30
    t = torch.arange(s, device=q.device)[None, :]
    tok_live = refined.gather(1, bucket_of.long()) & (t < vl[:, None].long())
    cent_live = ~refined & (counts > 0)
    bias = torch.cat([
        torch.where(tok_live, 0.0, neg),
        torch.where(cent_live, torch.log(torch.clamp_min(counts.float(), 1.0)),
                    neg)], dim=1)[:, None, None, :]
    keys = torch.cat([kc.float(), mk], dim=1).transpose(1, 2).contiguous()
    vals = torch.cat([vc.float(), mv], dim=1).transpose(1, 2).contiguous()
    qg = q.reshape(b, hkv, hq // hkv, dk)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qg, keys, vals, attn_mask=bias, scale=kwargs["scale"])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def build_kernels(build):
    t0 = time.perf_counter()
    out_dir = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s into "
          f"{out_dir.relative_to(Path(__file__).resolve().parent)}")
    for log in sorted(out_dir.glob("*.log")):   # nvcc -Xptxas=-v, a source
        text = log.read_text()
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spill = sum(int(n) for n in
                    re.findall(r"(\d+) bytes spill stores", text))
        print(f"  {log.stem}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers, {spill} bytes of spill stores")


def _host_ms(torch, fn):
    """(fn(), its time on the host clock up to a synchronise, in ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _timed_job(torch, ops, jobs, name, fn, kernels=KNN_KERNELS):
    """Run one job of a path once (cold), on the host clock up to a
    synchronise, and note the launches it made of the path's kernels."""
    before = ops.launch_counts()
    out, ms = _host_ms(torch, fn)
    after = ops.launch_counts()
    launches = {op: after[op] - before[op] for op in kernels}
    jobs[name] = {"ms": ms, "launches": launches}
    print(f"{name}: {ms:.1f} ms, launches {launches}")
    return out


def make_data(torch, make_mfeat_like):
    """(train_x, train_y, test_x, test_y) on the card at mfeat-factors
    scale, from seed 0."""
    x, y = make_mfeat_like(
        torch.Generator("cuda").manual_seed(0), n_points=N_TRAIN + N_QUERY,
        n_features=N_FEATURES, n_classes=N_CLASSES, modes_per_class=96,
        mode_scale=0.5, device="cuda",
    )
    return x[N_QUERY:], y[N_QUERY:], x[:N_QUERY], y[:N_QUERY]


def knn_jobs(torch, knn, train_x, train_y, test_x) -> dict:
    """The main path's jobs by name, each a call returning [Q] labels."""
    common = dict(k=K, n_classes=N_CLASSES, n_shards=N_SHARDS, device="cuda")
    jobs = {
        "run_exact": lambda: knn.run_exact(train_x, train_y, test_x,
                                           **common),
        "run_sampled": lambda: knn.run_sampled(
            train_x, train_y, test_x, sample_frac=SAMPLE_FRAC,
            sample_generator=torch.Generator("cuda").manual_seed(3),
            **common),
    }
    for eps in EPS_LEVELS:
        jobs[f"run_accurateml eps={eps}"] = (
            lambda eps=eps: knn.run_accurateml(
                train_x, train_y, test_x, compression_ratio=RATIO,
                eps_max=eps,
                lsh_generator=torch.Generator("cuda").manual_seed(1),
                **common))
    return jobs


def knn_path(torch, knn, engine, lsh, refine, ops, probe, train_x, train_y,
             test_x, test_y):
    """The port's kNN path, its kernel calls captured by ``probe``; returns
    (accuracies, shuffle_bytes, launch counts, per-job times and
    launches)."""
    ops.set_probe(probe)
    ops.reset_launch_counts()
    acc = {}
    jobs = {}
    timed_job = partial(_timed_job, torch, ops, jobs)
    for name, fn in knn_jobs(torch, knn, train_x, train_y, test_x).items():
        pred = timed_job(name, fn)
        acc[name] = knn.accuracy(pred, test_y)
        if pred.shape != (N_QUERY,) or not bool(
                ((pred >= 0) & (pred < N_CLASSES)).all()):
            fail(f"{name}: bad predictions")

    # One with_bound batch through the engine, on shard 0.
    n_s = train_x.shape[0] // N_SHARDS
    sx, sy = train_x[:n_s], train_y[:n_s]
    cfg = lsh.config_for_compression(n_s, RATIO)
    params = lsh.init_lsh(torch.Generator("cuda").manual_seed(2), N_FEATURES,
                          cfg)
    prepared = knn.build_knn_aggregates(sx, sy, params, N_CLASSES)
    budget = refine.eps_to_budget(n_s, EPS_LEVELS[-1])

    def reduce_fn(g):
        d, lab = knn.merge_topk(g[0], g[1], K)
        return d, lab, knn.majority_vote(d, lab, N_CLASSES), g[2].max(0).values

    mr = engine.MapReduce(mesh=None)
    out = timed_job("MapReduce accurateml_map with_bound", lambda: mr.run(
        partial(knn.accurateml_map, k=K, refine_budget=budget,
                with_bound=True),
        engine.CombineSpec(mode="all_gather", reduce_fn=reduce_fn),
        sx, sy, replicated_args=(prepared, test_x)))
    counts = ops.launch_counts()
    ops.set_probe(None)
    d, lab, vote, bound = out
    if d.shape != (N_QUERY, K) or bound.shape != (N_QUERY,):
        fail("with_bound batch: bad output shapes")
    if not bool(torch.isfinite(d).all()) or not bool(
            ((bound >= 0) & (bound <= 1)).all()):
        fail("with_bound batch: non-finite distances or bound outside [0,1]")
    acc["with_bound shard 0"] = knn.accuracy(vote, test_y)
    print(f"with_bound: mean bound {float(bound.mean()):.4f}, "
          f"budget {budget} originals per query")
    return acc, mr.last_shuffle_bytes, counts, jobs


def make_cf_data(torch, make_netflix_like, holdout_split):
    """(neighbourhood ratings, mask, active ratings, active mask, truth,
    test mask) on the card at the Netflix subset's scale, from seed 1: the
    split of benchmarks/common.py:52-66 (20 % held out, train ratings in)."""
    ratings, mask = make_netflix_like(
        torch.Generator("cuda").manual_seed(1), n_users=CF_USERS + CF_ACTIVE,
        n_items=CF_ITEMS, density=CF_DENSITY, device="cuda")
    train_mask, test_mask = holdout_split(
        torch.Generator("cuda").manual_seed(2), mask, 0.2, device="cuda")
    print(f"CF ratings: density {float(mask.mean()):.5f} (the generator "
          "clips the most popular items' rate at 0.95)")
    del mask
    train_r = ratings * train_mask
    a = CF_ACTIVE
    truth, test_mask = ratings[:a].clone(), test_mask[:a].clone()
    del ratings
    return (train_r[a:], train_mask[a:], train_r[:a], train_mask[:a], truth,
            test_mask)


def cf_jobs(torch, cf, nr, nm, a, am) -> dict:
    """The CF path's jobs by name, each a call returning [Q, I]
    predictions."""
    common = dict(n_shards=N_SHARDS, device="cuda")
    jobs = {
        "cf.run_exact": lambda: cf.run_exact(nr, nm, a, am, **common),
        "cf.run_sampled": lambda: cf.run_sampled(
            nr, nm, a, am, sample_frac=CF_SAMPLE_FRAC,
            sample_generator=torch.Generator("cuda").manual_seed(13),
            **common),
    }
    for eps in CF_EPS_LEVELS:
        jobs[f"cf.run_accurateml eps={eps}"] = (
            lambda eps=eps: cf.run_accurateml(
                nr, nm, a, am, compression_ratio=CF_RATIO, eps_max=eps,
                lsh_generator=torch.Generator("cuda").manual_seed(11),
                **common))
    return jobs


def check_predictions(torch, name, pred):
    if pred.shape != (CF_ACTIVE, CF_ITEMS) or not bool(
            torch.isfinite(pred).all()):
        fail(f"{name}: predictions not finite or of shape "
             f"{tuple(pred.shape)}")
    out = float(((pred < 1.0 - PRED_SLACK) | (pred > 5.0 + PRED_SLACK))
                .float().mean())
    if out >= PRED_OUT_SHARE:
        fail(f"{name}: {out:.2e} of the predictions lie outside [1, 5] +- "
             f"{PRED_SLACK} (allowed: under {PRED_OUT_SHARE}); range "
             f"[{float(pred.min())}, {float(pred.max())}]")
    return out


def check_rmse(cf, rmse, baseline):
    """Each job's RMSE between the noise floor and the user-mean baseline;
    the approximate jobs' loss against exact under RMSE_LOSS_MAX."""
    for name, r in rmse.items():
        if not (math.isfinite(r) and RMSE_FLOOR <= r < baseline):
            fail(f"{name}: RMSE {r} outside [{RMSE_FLOOR}, {baseline}) (the "
                 "noise floor, the user-mean baseline)")
        loss = cf.rmse_loss(rmse["cf.run_exact"], r)
        if name.startswith("cf.run_") and loss >= RMSE_LOSS_MAX:
            fail(f"{name}: RMSE loss {loss:.4f} against exact, not under "
                 f"{RMSE_LOSS_MAX}")


def cf_path(torch, cf, engine, lsh, refine, ops, probe, data):
    """The port's CF path, its kernel calls captured by ``probe``; every job
    runs cold, then once warm.  Returns (RMSEs, shuffle_bytes, launch
    counts, per-job times and launches)."""
    nr, nm, a, am, truth, tmask = data
    ops.set_probe(probe)
    ops.reset_launch_counts()
    rmse = {}
    jobs = {}
    for name, fn in cf_jobs(torch, cf, nr, nm, a, am).items():
        pred = _timed_job(torch, ops, jobs, name, fn, CF_KERNELS)
        out = check_predictions(torch, name, pred)
        rmse[name] = cf.rmse(pred, truth, tmask)
        warm, jobs[name]["warm_ms"] = _host_ms(torch, fn)
        if bool(((warm - pred).abs() > CF_TOL + CF_TOL * pred.abs()).any()):
            fail(f"{name}: the warm run gave other predictions")
        print(f"{name}: warm {jobs[name]['warm_ms']:.1f} ms, "
              f"RMSE {rmse[name]:.6f}, predictions in "
              f"[{float(pred.min()):.3f}, {float(pred.max()):.3f}], {out:.2e} "
              f"of them outside [1, 5] +- {PRED_SLACK}")

    # One with_bound batch through the engine, on shard 0: the psum combine
    # and the reduce of the serving adapter (src/repro/apps/cf.py:CFServable).
    n_s = nr.shape[0] // N_SHARDS
    sr, sm = nr[:n_s], nm[:n_s]
    cfg = lsh.config_for_compression(n_s, CF_RATIO, n_hashes=4,
                                     bucket_width=8.0)
    params = lsh.init_lsh(torch.Generator("cuda").manual_seed(12), CF_ITEMS,
                          cfg)
    prepared = cf.build_cf_aggregates(sr, sm, params)
    budget = refine.eps_to_budget(n_s, CF_EPS_LEVELS[-1])

    def reduce_fn(nd):
        pred = cf.predict(nd[0], nd[1], a, am)
        stderr = torch.where(nd[1] > 1e-8,
                             nd[2].sqrt() / torch.clamp_min(nd[1], 1e-8), 0.0)
        return pred, cf.CF_BOUND_Z * stderr.mean(dim=-1)

    mr = engine.MapReduce(mesh=None)
    pred, bound = _timed_job(
        torch, ops, jobs, "cf MapReduce accurateml_map with_bound",
        lambda: mr.run(
            partial(cf.accurateml_map, refine_budget=budget, with_bound=True),
            engine.CombineSpec(mode="psum", reduce_fn=reduce_fn),
            sr, sm, replicated_args=(prepared, a, am)),
        CF_KERNELS)
    counts = ops.launch_counts()
    ops.set_probe(None)
    check_predictions(torch, "cf with_bound batch", pred)
    if bound.shape != (CF_ACTIVE,) or not bool(
            (torch.isfinite(bound) & (bound >= 0)).all()):
        fail("cf with_bound batch: bound not finite and >= 0")
    rmse["cf with_bound shard 0"] = cf.rmse(pred, truth, tmask)
    print(f"cf with_bound: mean bound {float(bound.mean()):.4f} stars, "
          f"budget {budget} users per query, RMSE "
          f"{rmse['cf with_bound shard 0']:.6f}")
    baseline = cf.rmse(cf.predict(torch.zeros_like(a), torch.zeros_like(a),
                                  a, am), truth, tmask)
    print(f"CF user-mean baseline RMSE {baseline:.6f}")
    check_rmse(cf, rmse, baseline)
    return rmse, mr.last_shuffle_bytes, counts, jobs


def lsh_phase(torch, ref, lsh, ops, probe, knn_rows, cf_ratings, cf_mask):
    """ops.lsh_hash on the hash inputs of both paths: kNN shard 0's rows
    and CF shard 0's centred profiles, each with its path's LSH config."""
    ops.set_probe(probe)
    ops.reset_launch_counts()
    for name, x, cfg in (
        ("kNN shard 0", knn_rows,
         lsh.config_for_compression(knn_rows.shape[0], RATIO)),
        ("CF shard 0", ref._centred(cf_ratings, cf_mask),
         lsh.config_for_compression(cf_ratings.shape[0], CF_RATIO,
                                    n_hashes=4, bucket_width=8.0)),
    ):
        params = lsh.init_lsh(torch.Generator("cuda").manual_seed(14),
                              x.shape[1], cfg)
        h, ms = _host_ms(torch, lambda: ops.lsh_hash(x, params.a, params.b,
                                                     cfg.bucket_width))
        print(f"lsh_hash on {name} {tuple(x.shape)}: {tuple(h.shape)} "
              f"hashes, {ms:.2f} ms cold")
    counts = ops.launch_counts()
    ops.set_probe(None)
    return counts


# ---------------------------------------------------------------------------
# the aggregate store: pyramids, snapshot, streaming ingest, the servables
# ---------------------------------------------------------------------------

def _ms_since(torch, t0) -> float:
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _same_level(torch, what, got, want, fields):
    """Two prepared levels give the same bits in every named field."""
    for f in fields:
        x, y = got, want
        for part in f.split("."):
            x, y = getattr(x, part), getattr(y, part)
        if x.dtype != y.dtype or not torch.equal(x, y):
            fail(f"store: {what}: {f} differs")


KNN_LEVEL_FIELDS = ("agg.counts", "agg.means", "agg.perm", "agg.offsets",
                    "agg.bucket_of", "bucket_labels", "spread", "dispersion")
CF_LEVEL_FIELDS = ("profile", "profile_mask", "s", "c", "cvar", "agg.counts",
                   "agg.perm", "agg.offsets")


def _knn_answer(torch, knn, servables, prepared, queries, budget):
    """Each shard's servable answers the batch; the shards fold through
    merge_topk and majority_vote, as the job does.  -> (per-shard outputs,
    [Q] votes)."""
    outs = [s.run(p, (queries,), refine_budget=budget)
            for s, p in zip(servables, prepared)]
    for d, lab, vote, bound in outs:
        if d.shape != (queries.shape[0], K) or not bool(
                ((bound >= 0) & (bound <= 1)).all()) or not bool(
                ((vote >= 0) & (vote < N_CLASSES)).all()):
            fail("store: a kNN servable answered out of shape or range")
    d, lab = knn.merge_topk(torch.stack([o[0] for o in outs]),
                            torch.stack([o[1] for o in outs]), K)
    return outs, knn.majority_vote(d, lab, N_CLASSES)


def _reordered_rows(torch, knn, cold, other, queries, budget):
    """[Q] bool: queries whose stage-1 ranking over the ``cold`` level may
    differ over ``other``, a level whose centroids differ from the cold ones
    in rounding only: two neighbouring buckets, among the ranks the budget
    reaches (the covered ones and the first one left out), lie closer than
    twice the query's largest difference of centroid distances between the
    two levels, so the two levels may refine other buckets."""
    live = cold.agg.counts[None, :] > 0
    d0 = knn.pairwise_sq_dists(queries, cold.agg.means)
    d1 = knn.pairwise_sq_dists(queries, other.agg.means)
    pert = torch.where(live, (d1 - d0).abs(), 0.0).amax(dim=1)
    vals, order = torch.sort(torch.where(live, d0, knn.BIG), dim=1,
                             stable=True)
    reach = torch.cumsum(cold.agg.counts.long()[order], dim=1) <= budget
    reach[:, 1:] |= reach[:, :-1].clone()          # one rank past the last
    close = (vals[:, 1:] - vals[:, :-1]) <= 2 * pert[:, None]
    return (close & reach[:, 1:] & (vals[:, 1:] < knn.BIG / 2)).any(dim=1)


def store_phase(torch, knn, cf, lsh, refine, ops, probe, knn_data, cf_data,
                cf_rmse_exact):
    """The store path at the jobs' sizes; returns (summary, launch counts
    of the path, the checks' numbers).  The path: per kNN shard a
    KNNServable over one shared AggregateStore (get(100) built, the test
    queries answered at eps 0 and 0.01 and folded, get(400) and get(25)
    merged, the store saved and restored into a fresh store whose get(100)
    is restored), per CF shard a CFServable (get(20) built, run at eps
    0.05, get(80) and get(40) merged), and a StreamingAggregate over kNN
    shard 0 adopted into a pyramid whose get(100) is merged.  The checks
    that follow read back with the kernels' counts already taken."""
    import tempfile

    from repro_torch.store import (
        SOURCE_BUILT, SOURCE_MERGED, SOURCE_RESTORED, AggregateStore,
        StreamingAggregate,
    )

    t_phase = time.perf_counter()
    train_x, train_y, test_x, test_y = knn_data
    nr, nm, a, am, truth, tmask = cf_data
    dev = train_x.device
    n_s = train_x.shape[0] // N_SHARDS
    ms = {}

    def expect(source, want, what):
        if source != want:
            fail(f"store: {what} came {source}, expected {want}")

    ops.set_probe(probe)
    ops.reset_launch_counts()

    # ---- kNN: one servable per shard, one store ----
    store = AggregateStore()
    shards = [knn.KNNServable(
        train_x[sl], train_y[sl], n_classes=N_CLASSES, k=K,
        lsh_generator=torch.Generator(dev).manual_seed(STORE_SEED + s),
        store=store, device=dev)
        for s, sl in enumerate(knn._shard_slices(train_x.shape[0],
                                                 N_SHARDS))]
    spec = shards[0].pyramid_spec
    t0 = time.perf_counter()
    built = []
    for s in shards:
        prepared, source = store.get(s, STORE_RATIOS[0])
        expect(source, SOURCE_BUILT, f"kNN get({STORE_RATIOS[0]})")
        built.append(prepared)
    ms["knn build"] = _ms_since(torch, t0)
    budgets = (0, refine.eps_to_budget(n_s, EPS_LEVELS[-1]))
    answers, acc = {}, {}
    for budget in budgets:
        t0 = time.perf_counter()
        answers[budget] = _knn_answer(torch, knn, shards, built, test_x,
                                      budget)
        ms[f"knn answer budget {budget}"] = _ms_since(torch, t0)
        acc[f"store kNN budget {budget}"] = knn.accuracy(answers[budget][1],
                                                         test_y)
    merged = {}
    for ratio in STORE_RATIOS[1:]:
        t0 = time.perf_counter()
        for i, s in enumerate(shards):
            prepared, source = store.get(s, ratio)
            expect(source, SOURCE_MERGED, f"kNN get({ratio})")
            if i == 0:
                merged[ratio] = prepared
        ms[f"knn merge {ratio:g}"] = _ms_since(torch, t0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        n_saved = store.save(Path(tmp) / "snap")
        ms["knn save"] = _ms_since(torch, t0)
        fresh = AggregateStore()
        t0 = time.perf_counter()
        n_restored = fresh.restore(Path(tmp) / "snap", shards)
        ms["knn restore"] = _ms_since(torch, t0)
    if n_saved != N_SHARDS or n_restored != N_SHARDS:
        fail(f"store: saved {n_saved}, restored {n_restored} of {N_SHARDS} "
             "pyramids")
    t0 = time.perf_counter()
    restored = []
    for s in shards:
        prepared, source = fresh.get(s, STORE_RATIOS[0])
        expect(source, SOURCE_RESTORED, "the fresh store's kNN get")
        restored.append(prepared)
    ms["knn restored get"] = _ms_since(torch, t0)
    restored_answer = _knn_answer(torch, knn, shards, restored, test_x,
                                  budgets[-1])

    # ---- CF: one servable per shard, one store ----
    cf_store = AggregateStore()
    cf_shards = [cf.CFServable(
        nr[sl], nm[sl],
        lsh_generator=torch.Generator(dev).manual_seed(STORE_SEED + 10 + s),
        store=cf_store, device=dev)
        for s, sl in enumerate(cf._shard_slices(nr.shape[0], N_SHARDS))]
    t0 = time.perf_counter()
    cf_built = []
    for s in cf_shards:
        prepared, source = cf_store.get(s, CF_STORE_RATIOS[0])
        expect(source, SOURCE_BUILT, f"CF get({CF_STORE_RATIOS[0]})")
        cf_built.append(prepared)
    ms["cf build"] = _ms_since(torch, t0)
    cf_budget = refine.eps_to_budget(cf_shards[0].n_points,
                                     CF_EPS_LEVELS[-1])
    t0 = time.perf_counter()
    cf_out = [s.run(p, (a, am), refine_budget=cf_budget)
              for s, p in zip(cf_shards, cf_built)]
    ms["cf answer"] = _ms_since(torch, t0)
    for pred, bound in cf_out:
        if not bool(torch.isfinite(pred).all()) or not bool(
                (torch.isfinite(bound) & (bound >= 0)).all()):
            fail("store: a CF servable answered non-finite predictions or "
                 "bounds")
    cf_merged = {}
    for ratio in CF_STORE_RATIOS[1:]:
        t0 = time.perf_counter()
        for i, s in enumerate(cf_shards):
            prepared, source = cf_store.get(s, ratio)
            expect(source, SOURCE_MERGED, f"CF get({ratio})")
            if i == 0:
                cf_merged[ratio] = prepared
        ms[f"cf merge {ratio:g}"] = _ms_since(torch, t0)

    # ---- streaming ingest of kNN shard 0 ----
    s0 = shards[0]
    base_params = lsh.LSHParams(
        a=s0.lsh_a, b=s0.lsh_b,
        config=lsh.LSHConfig(n_hashes=s0.n_hashes,
                             bucket_width=s0.bucket_width,
                             n_buckets=spec.base_buckets))
    stream = StreamingAggregate(
        base_params, N_FEATURES, capacity=n_s, chunk=STREAM_CHUNK,
        extra_shapes={"sumsq": (N_FEATURES,), "label_hist": (N_CLASSES,)},
        device=dev)
    cuts = [0, *sorted(torch.randperm(
        n_s - 1, generator=torch.Generator().manual_seed(STORE_SEED))
        [:STREAM_BATCHES - 1].add(1).tolist()), n_s]
    classes = torch.arange(N_CLASSES, device=dev)
    t0 = time.perf_counter()
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        rows = s0.train_x[lo:hi]
        stream.append(rows, sumsq=rows * rows, label_hist=(
            s0.train_y[lo:hi, None] == classes).float())
    ms["stream ingest"] = _ms_since(torch, t0)
    t0 = time.perf_counter()
    s_stats, s_index, s_n = stream.level0()
    ms["stream rebucket"] = _ms_since(torch, t0)
    streamed = knn.KNNServable(
        stream.rows(), s0.train_y, n_classes=N_CLASSES, k=K,
        lsh_params=(s0.lsh_a, s0.lsh_b), device=dev)
    streamed.store.adopt(streamed, s_stats, s_index)
    s_prepared, source = streamed.store.get(streamed, STORE_RATIOS[0])
    expect(source, SOURCE_MERGED, "the streamed pyramid's get")
    s_answer = {b: streamed.run(s_prepared, (test_x,), refine_budget=b)
                for b in budgets}
    counts = ops.launch_counts()
    ops.set_probe(None)

    summary = {
        "ms": ms, "accuracy": acc, "store": store.stats(),
        "cf_store": cf_store.stats(), "restored_store": fresh.stats(),
        "knn_spec": dataclasses.asdict(spec),
        "cf_spec": dataclasses.asdict(cf_shards[0].pyramid_spec),
        "knn_buckets": {r: spec.n_buckets(spec.level_for_ratio(r))
                        for r in STORE_RATIOS},
        "cf_buckets": {r: cf_shards[0].pyramid_spec.n_buckets(
            cf_shards[0].pyramid_spec.level_for_ratio(r))
            for r in CF_STORE_RATIOS},
        "stream": {"batches": len(cuts) - 1, "chunk": STREAM_CHUNK,
                   "chunks": sum(math.ceil((hi - lo) / STREAM_CHUNK)
                                 for lo, hi in zip(cuts[:-1], cuts[1:]))},
    }

    # ---- checks (the counts are taken) ----
    # merged levels against cold builds, to the bit
    for ratio in STORE_RATIOS[1:]:
        cold, source = AggregateStore().get(shards[0], ratio)
        expect(source, SOURCE_BUILT, "a cold kNN get")
        _same_level(torch, f"kNN merged get({ratio}) vs cold", merged[ratio],
                    cold, KNN_LEVEL_FIELDS)
    for ratio in CF_STORE_RATIOS[1:]:
        cold, source = AggregateStore().get(cf_shards[0], ratio)
        expect(source, SOURCE_BUILT, "a cold CF get")
        _same_level(torch, f"CF merged get({ratio}) vs cold",
                    cf_merged[ratio], cold, CF_LEVEL_FIELDS)
    # the restored levels and their answers
    for i, (r, b) in enumerate(zip(restored, built)):
        _same_level(torch, f"kNN shard {i} restored vs built", r, b,
                    KNN_LEVEL_FIELDS)
    built_answer = answers[budgets[-1]]
    for got, want in zip(restored_answer[0], built_answer[0]):
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            fail("store: answers from the restored levels differ from the "
                 "built ones")
    if not torch.equal(restored_answer[1], built_answer[1]):
        fail("store: votes from the restored levels differ")
    # streamed state against the cold build of shard 0
    pyr = store.pyramid(s0)
    c_stats, c_index = pyr.stats_at(0), pyr.index_at(0)
    if s_n != n_s:
        fail(f"store: streamed {s_n} rows of {n_s}")
    for f in ("perm", "offsets", "bucket_of"):
        if not torch.equal(getattr(s_index, f), getattr(c_index, f)):
            fail(f"store: the streamed index's {f} differs from a cold build")
    if not torch.equal(s_stats["counts"], c_stats["counts"]):
        fail("store: streamed counts differ from a cold build")
    sum_err = {}
    for name in ("sums", "sumsq", "label_hist"):
        err = (s_stats[name] - c_stats[name]).abs()
        sum_err[name] = float(err.max())
        if bool((err > ATOL + RTOL * c_stats[name].abs()).any()):
            fail(f"store: streamed {name} beyond {RTOL} of a cold build "
                 f"(max err {sum_err[name]:.3e})")
    # streamed answers against the cold level's: the streamed centroids
    # differ in rounding only, so the top-k agree to tolerance and the
    # labels but at near-ties, at eps 0 on every query and at eps 0.01 on
    # every query whose refined buckets that rounding cannot change
    big = knn.BIG
    cold0 = built[0]
    stream_check = {"max_abs_err": sum_err}
    for budget in budgets:
        reordered = (_reordered_rows(torch, knn, cold0, s_prepared, test_x,
                                     budget) if budget else
                     torch.zeros(test_x.shape[0], dtype=torch.bool,
                                 device=dev))
        keep = ~reordered
        got, want = s_answer[budget], answers[budget][0][0]
        nxt = knn.accurateml_map(s0.train_x, s0.train_y, cold0, test_x,
                                 k=K + 1, refine_budget=budget)[0][:, K]
        _, mism, ties, examples, _ = compare_topk(
            torch, big, got[0][keep], got[1][keep], want[0][keep],
            want[1][keep], nxt[keep])
        stream_check[f"budget {budget}"] = {
            "label_mismatch": mism, "near_ties": ties,
            "near_tie_examples": examples,
            "rows_reordered": int(reordered.sum()),
            "votes_differ": int((got[2] != want[2]).sum()),
            "votes_differ_not_reordered": int(((got[2] != want[2])
                                               & keep).sum())}
    summary["stream_check"] = stream_check
    # a full budget is exact kNN (every bucket covered)
    q = test_x[:EXACT_QUERIES]
    d, lab, vote, _ = s0.run(built[0], (q,), refine_budget=n_s)
    ed, el = knn.exact_map(s0.train_x, s0.train_y, q, k=K + 1)
    _, ex_mism, ex_ties, ex_examples, ex_rows = compare_topk(
        torch, big, d, lab, ed[:, :K], el[:, :K], ed[:, K])
    ev = knn.majority_vote(ed[:, :K], el[:, :K], N_CLASSES)
    if bool(((vote != ev) & ~ex_rows).any()):
        fail("store: full-budget votes differ from exact_map's on rows "
             "without a near-tie")
    summary["exact_check"] = {"queries": EXACT_QUERIES, "budget": n_s,
                              "label_mismatch": ex_mism,
                              "near_ties": ex_ties,
                              "near_tie_examples": ex_examples}
    # CF: the shards' map outputs summed, as the job does, then predicted
    num = den = 0.0
    for s, p in zip(cf_shards, cf_built):
        n_, d_ = cf.accurateml_map(s.ratings, s.mask, p, a, am,
                                   refine_budget=cf_budget)
        num, den = num + n_, den + d_
    pred = cf.predict(num, den, a, am)
    check_predictions(torch, "store CF fold", pred)
    rmse = {"cf.run_exact": cf_rmse_exact,
            "store CF eps 0.05": cf.rmse(pred, truth, tmask)}
    baseline = cf.rmse(cf.predict(torch.zeros_like(a), torch.zeros_like(a),
                                  a, am), truth, tmask)
    check_rmse(cf, rmse, baseline)
    summary["rmse"] = rmse["store CF eps 0.05"]
    summary["rmse_loss"] = cf.rmse_loss(cf_rmse_exact, summary["rmse"])
    if summary["rmse_loss"] >= RMSE_LOSS_MAX:
        fail(f"store CF: RMSE loss {summary['rmse_loss']:.4f} against exact, "
             f"not under {RMSE_LOSS_MAX}")
    summary["cf_shard_rmse"] = [cf.rmse(p, truth, tmask) for p, _ in cf_out]
    summary["phase_s"] = time.perf_counter() - t_phase
    return summary, counts


def print_store(summary):
    """The store phase's lines: build, merge, save and restore ms, the
    stores' stats(), the accuracies, the RMSE and the checks' counts."""
    n_s = summary["knn_spec"]["n_points"]
    cf_n_s = summary["cf_spec"]["n_points"]
    sms = summary["ms"]
    print(f"store kNN ({N_SHARDS} shards of {n_s} x {N_FEATURES}, base "
          f"{summary['knn_spec']['base_buckets']} buckets, "
          f"{summary['knn_spec']['n_levels']} levels): build "
          f"{sms['knn build']:.1f} ms, merge "
          + ", ".join(f"{sms[f'knn merge {r:g}']:.1f} ms (get({r:g}))"
                      for r in STORE_RATIOS[1:])
          + f", save {sms['knn save']:.1f} ms, restore "
          f"{sms['knn restore']:.1f} ms (+ {sms['knn restored get']:.1f} ms "
          "for the restored get)")
    print(f"store CF ({N_SHARDS} shards of {cf_n_s} x {CF_ITEMS}, base "
          f"{summary['cf_spec']['base_buckets']} buckets): build "
          f"{sms['cf build']:.1f} ms, merge "
          + ", ".join(f"{sms[f'cf merge {r:g}']:.1f} ms (get({r:g}))"
                      for r in CF_STORE_RATIOS[1:])
          + f", answer {sms['cf answer']:.1f} ms")
    print(f"store streaming ({summary['stream']['batches']} appends, "
          f"{summary['stream']['chunks']} chunks of {STREAM_CHUNK}): "
          f"ingest {sms['stream ingest']:.1f} ms, rebucket "
          f"{sms['stream rebucket']:.1f} ms; {summary['stream_check']}")
    for name in ("store", "cf_store", "restored_store"):
        print(f"{name} stats(): {summary[name]}")
    for name, a in summary["accuracy"].items():
        print(f"accuracy {name}: {a:.4f}")
    print(f"RMSE store CF eps 0.05: {summary['rmse']:.6f}, RMSE loss "
          f"vs exact {summary['rmse_loss']:.6f}")
    print(f"store full budget vs exact_map: {summary['exact_check']}")
    print(f"store phase: {summary['phase_s']:.1f} s, its checks included")


def _to_cuda(dc):
    return type(dc)(**{f.name: getattr(dc, f.name).cuda()
                       for f in dataclasses.fields(dc)})


def small_check(torch, knn, lsh, refine, make_mfeat_like):
    """End-to-end answers on the card against the same functions on the CPU
    (the plain versions), on a small input and the same aggregates."""
    from repro_torch.kernels import topk_stream

    gen = torch.Generator("cuda").manual_seed(5)
    x, y = make_mfeat_like(gen, n_points=40_000 + 256,
                           n_features=N_FEATURES, n_classes=N_CLASSES,
                           modes_per_class=96, mode_scale=0.5, device="cuda")
    tx, ty, qx = x[256:], y[256:], x[:256]
    cpu = [t.cpu() for t in (tx, ty, qx)]
    big = topk_stream.BIG

    # exact map + merge over 2 shards
    n2 = tx.shape[0] // 2
    outs = {}
    for dev, (a, b, q) in (("cuda", (tx, ty, qx)), ("cpu", cpu)):
        parts = [knn.exact_map(a[s * n2:(s + 1) * n2], b[s * n2:(s + 1) * n2],
                               q, k=K + 1) for s in range(2)]
        outs[dev] = knn.merge_topk(torch.stack([p[0] for p in parts]),
                                   torch.stack([p[1] for p in parts]), K + 1)
    gd, gl = outs["cuda"]
    wd, wl = outs["cpu"]
    _, mism, ties, _, tie_rows = compare_topk(
        torch, big, gd[:, :K].cpu(), gl[:, :K].cpu(), wd[:, :K], wl[:, :K],
        wd[:, K])
    vg = knn.majority_vote(gd[:, :K], gl[:, :K], N_CLASSES).cpu()
    vw = knn.majority_vote(wd[:, :K], wl[:, :K], N_CLASSES)
    if bool((vg != vw)[~tie_rows].any()):
        fail("small exact: votes differ on rows without a near-tie")
    print(f"small exact (2 shards, cuda vs cpu): {mism} label mismatches, "
          f"all {ties} at near-ties; votes equal on "
          f"{int((vg == vw).sum())}/{vg.numel()}")

    # accurateml_map with_bound on the same aggregates, budget 0 and > 0
    cfg = lsh.config_for_compression(tx.shape[0], RATIO)
    params = lsh.init_lsh(torch.Generator().manual_seed(9), N_FEATURES, cfg,
                          device="cpu")
    agg_cpu = knn.build_knn_aggregates(cpu[0], cpu[1], params, N_CLASSES)
    agg_gpu = knn.KNNAggregates(
        agg=_to_cuda(agg_cpu.agg), bucket_labels=agg_cpu.bucket_labels.cuda(),
        spread=agg_cpu.spread.cuda(), dispersion=agg_cpu.dispersion.cuda())
    for budget in (0, refine.eps_to_budget(tx.shape[0], EPS_LEVELS[-1])):
        g = knn.accurateml_map(tx, ty, agg_gpu, qx, k=K,
                               refine_budget=budget, with_bound=True)
        w = knn.accurateml_map(*cpu[:2], agg_cpu, cpu[2], k=K,
                               refine_budget=budget, with_bound=True)
        # plain ranking at k+1 for the near-tie test
        w_ext = knn.accurateml_map(*cpu[:2], agg_cpu, cpu[2], k=K + 1,
                                   refine_budget=budget)
        _, mism, ties, _, tie_rows = compare_topk(
            torch, big, g[0].cpu(), g[1].cpu(), w[0], w[1], w_ext[0][:, K])
        berr = (g[2].cpu() - w[2]).abs()[~tie_rows]
        if bool((berr > 1e-4).any()):
            fail(f"small accurateml budget {budget}: bound differs by "
                 f"{float(berr.max()):.3e}")
        print(f"small accurateml_map with_bound budget {budget} (cuda vs "
              f"cpu): {mism} label mismatches, all {ties} at near-ties; "
              f"bound max err {float(berr.max()) if berr.numel() else 0:.2e}")

    # aggregation gives the same bits twice on the card
    params_gpu = lsh.LSHParams(a=params.a.cuda(), b=params.b.cuda(),
                               config=params.config)
    a1 = knn.build_knn_aggregates(tx, ty, params_gpu, N_CLASSES)
    a2 = knn.build_knn_aggregates(tx, ty, params_gpu, N_CLASSES)
    for one, two in ((a1.agg, a2.agg), (a1, a2)):
        for f in dataclasses.fields(one):
            a, b = getattr(one, f.name), getattr(two, f.name)
            if isinstance(a, torch.Tensor) and not torch.equal(a, b):
                fail(f"aggregation not deterministic: {f.name}")
    print("aggregation: identical bits on two runs")


def _stage1_tie_rows(torch, cf, ops, agg, a, am, budget):
    """[Q] bool: queries whose stage-1 ranking has two neighbouring buckets
    within RANK_TIE_TOL of each other among the ranks the budget reaches
    (the covered ones and the first one left out).  Computed with the plain
    versions (CPU tensors)."""
    w = ops.cf_weights(a, am, agg.profile, agg.profile_mask)
    w = cf.shrink_weights(w, am @ agg.profile_mask.T).abs()
    w = torch.where(agg.agg.counts[None, :] > 0, w, -1.0)
    vals, order = torch.sort(w, dim=1, descending=True, stable=True)
    reach = torch.cumsum(agg.agg.counts.long()[order], dim=1) <= budget
    reach[:, 1:] |= reach[:, :-1].clone()          # one rank past the last
    close = (vals[:, :-1] - vals[:, 1:]).abs() <= RANK_TIE_TOL
    return (close & reach[:, 1:]).any(dim=1)


def cf_small_check(torch, cf, lsh, refine, ops, make_netflix_like,
                   holdout_split):
    """CF answers on the card against the same functions on the CPU (the
    plain versions), on 4,000 users x 2,000 items and the same aggregates;
    aggregation gives the same bits twice on the card."""
    n_users, n_act, n_items = 4000, 128, 2000
    r, m = make_netflix_like(torch.Generator("cuda").manual_seed(6),
                             n_users=n_users + n_act, n_items=n_items,
                             density=0.05, device="cuda")
    tr, te = holdout_split(torch.Generator("cuda").manual_seed(7), m, 0.2,
                           device="cuda")
    trr = r * tr
    gpu = (trr[n_act:], tr[n_act:], trr[:n_act], tr[:n_act])
    cpu = [t.cpu() for t in gpu]
    truth, tmask = r[:n_act], te[:n_act]

    def close(name, got, want, ties=None, again=None):
        """Every row within tolerance, or excused by a near-tie; returns
        the number of rows excused.  On a failure, ``again`` (when given)
        recomputes ``want``, and the message says whether it gave the same
        bits, so that a fault of the host's side shows as such."""
        excused = 0
        for i, (g, w) in enumerate(zip(got, want)):
            err = (g.cpu() - w).abs()
            ratio = (err / (CF_TOL + CF_TOL * w.abs())).amax(1)
            bad = ratio > 1
            if ties is not None:
                excused = max(excused, int((bad & ties).sum()))
                bad &= ~ties
            if bool(bad.any()):
                rows = bad.nonzero().flatten().tolist()
                redo = ""
                if again is not None:
                    same = all(torch.equal(x, y)
                               for x, y in zip(again(), want))
                    redo = ("; the CPU gives the same bits again" if same
                            else "; the CPU gives other bits when run again")
                fail(f"small CF {name} output {i}: {len(rows)} rows "
                     f"differ beyond tolerance (rows {rows[:32]}, largest "
                     f"error {float(err[bad].max()):.3e}, "
                     f"{float(ratio.max()):.1f}x the tolerance{redo})")
        return excused

    got = cf.exact_map(*gpu)
    if not all(torch.equal(x, y) for x, y in zip(got, cf.exact_map(*gpu))):
        fail("small CF exact_map: two runs on the card differ")
    close("exact_map", got, cf.exact_map(*cpu),
          again=lambda: cf.exact_map(*cpu))
    print(f"small CF exact_map (cuda vs cpu): num/den within {CF_TOL} on "
          "every row, the same bits on two runs on the card")
    pred_g = cf.run_exact(*gpu, n_shards=2, device="cuda")
    pred_w = cf.run_exact(*cpu, n_shards=2, device="cpu")
    err = abs(cf.rmse(pred_g, truth, tmask)
              - cf.rmse(pred_w, truth.cpu(), tmask.cpu()))
    if err > 1e-4:
        fail(f"small CF run_exact: RMSE differs by {err:.2e}")

    cfg = lsh.config_for_compression(n_users, CF_RATIO, n_hashes=4,
                                     bucket_width=8.0)
    params = lsh.init_lsh(torch.Generator().manual_seed(9), n_items, cfg,
                          device="cpu")
    agg_cpu = cf.build_cf_aggregates(cpu[0], cpu[1], params)
    agg_gpu = cf.CFAggregates(
        agg=_to_cuda(agg_cpu.agg),
        **{f.name: getattr(agg_cpu, f.name).cuda()
           for f in dataclasses.fields(agg_cpu) if f.name != "agg"})
    for budget in (0, refine.eps_to_budget(n_users, CF_EPS_LEVELS[-1])):
        g = cf.accurateml_map(*gpu[:2], agg_gpu, *gpu[2:],
                              refine_budget=budget, with_bound=True)
        w = cf.accurateml_map(*cpu[:2], agg_cpu, *cpu[2:],
                              refine_budget=budget, with_bound=True)
        ties = _stage1_tie_rows(torch, cf, ops, agg_cpu, cpu[2], cpu[3],
                                budget) if budget else None
        excused = close(f"accurateml_map budget {budget}", g, w, ties)
        print(f"small CF accurateml_map with_bound budget {budget} (cuda vs "
              f"cpu): num/den/varsum within {CF_TOL} on every row but "
              f"{excused}, each at a stage-1 near-tie "
              f"({0 if ties is None else int(ties.sum())} of {n_act} "
              "queries have one)")
    print(f"small CF run_exact (cuda vs cpu): RMSE differs by {err:.2e}")

    params_gpu = lsh.LSHParams(a=params.a.cuda(), b=params.b.cuda(),
                               config=params.config)
    a1 = cf.build_cf_aggregates(*gpu[:2], params_gpu)
    a2 = cf.build_cf_aggregates(*gpu[:2], params_gpu)
    for one, two in ((a1.agg, a2.agg), (a1, a2)):
        for f in dataclasses.fields(one):
            x, y = getattr(one, f.name), getattr(two, f.name)
            if isinstance(x, torch.Tensor) and not torch.equal(x, y):
                fail(f"CF aggregation not deterministic: {f.name}")
    print("CF aggregation: identical bits on two runs")


# ---------------------------------------------------------------------------
# aggregated-KV LM decode
# ---------------------------------------------------------------------------

def lm_prompts(vocab: int, n: int, length: int, seed: int):
    import numpy as np
    return np.random.default_rng(seed).integers(0, vocab, (n, length))


def lm_generate(torch, engine, prefixes, rf, steps):
    """Insert prefix i into slot i, then ``steps`` decode steps at ``rf``:
    (tokens [slots, steps + 1], logits [slots, steps + 1, V] f32, host ms a
    step).  Column 0 is each prefix's own token and logits, as
    benchmarks/decode_bench.py counts them."""
    engine.free_all()
    for i, pf in enumerate(prefixes):
        engine.insert(pf, i)
    toks = [torch.tensor([pf.next_token for pf in prefixes],
                         dtype=torch.int32, device=engine.device)]
    logits = [torch.stack([pf.logits for pf in prefixes])]
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        nxt, lg = engine.generate_step(rf)   # returns after the card is done
        times.append((time.perf_counter() - t0) * 1e3)
        toks.append(nxt)
        logits.append(lg)
    return torch.stack(toks, 1), torch.stack(logits, 1), times


def lm_kl(torch, p_logits, q_logits) -> float:
    """Mean KL(softmax(p) || softmax(q)) over every position
    (benchmarks/decode_bench.py:_kl), in float64."""
    lp = torch.log_softmax(p_logits.double(), dim=-1)
    lq = torch.log_softmax(q_logits.double(), dim=-1)
    return float((lp.exp() * (lp - lq)).sum(-1).mean())


def lm_max_count(engine) -> tuple[int, int]:
    """(largest bucket count over every aggregated layer and slot, slots a
    bucket); (0, 0) for a model without aggregated layers."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.aggregated_kv import BucketMajorKVCache

    caches = model_lib.aggregated_caches(engine.state)
    if not caches:
        return 0, 0
    worst = max(int(c.counts.max()) for c in caches)
    cap = (caches[0].capacity if isinstance(caches[0], BucketMajorKVCache)
           else 2 * engine.cfg.agg_compression)
    return worst, cap


def n_aggregated(cfg) -> int:
    """The layers that decode over an aggregated cache: each makes one
    attention launch and one selection a token (the layer count for the
    attention-only models; zamba2's shared-attention slots, gemma3's global
    layers; none in xLSTM)."""
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer

    return sum(transformer.uses_agg(cfg, kind)
               for kind in model_lib.block_kinds(cfg))


def lm_path(torch, ops, probe, engine_cls, model, cfg, layout, prompts,
            jobs, *, name="LM", sweep=LM_SWEEP, steps=LM_NEW_TOKENS - 1,
            warm=LM_WARM_STEPS, dev="cuda", s_max=LM_S_MAX):
    """One model and layout of the LM path: prefill every prompt at batch
    1, then at each refine_frac of ``sweep`` re-insert the same prefixes,
    take ``warm`` untimed decode steps and ``steps`` timed ones.  One
    launch of the layout's attention kernel and one batched selection an
    aggregated layer (``n_aggregated``), a prefill token and a decode step
    (none of either at rf 0 but the flat kernel, which takes the centroids
    too), else the run fails.  The kernels' inputs are captured (cloned) at
    the first prompt's last position (the batch-1 prefill shapes; each
    aggregated layer calls each kernel once a token, so the probe lets
    (length - 1) x layers calls of a key pass first), and every kernel's
    must be, and during the untimed steps; a model without aggregated
    layers (xLSTM) must launch none.
    ``name`` heads the lines printed and (lower-cased) the ``jobs`` keys.
    Returns the per-level summary and the path's launch counts."""
    path, key = f"{name} {layout}", f"{name.lower()} {layout}"
    cfg = cfg.with_(agg_layout=layout)
    kernels = LM_KERNELS[layout]
    n_agg = n_aggregated(cfg)
    torch.cuda.reset_peak_memory_stats()
    engine = engine_cls(model, cfg, max_slots=LM_SLOTS, s_max=s_max,
                        generator=torch.Generator(dev).manual_seed(7))
    ops.reset_launch_counts()
    prefixes, prefill_ms = [], []
    probe.tag = f"{path} prefill"
    probe.skip = (prompts.shape[1] - 1) * n_agg
    for i, prompt in enumerate(prompts):
        ops.set_probe(probe if i == 0 else None)
        pf, ms = _host_ms(torch, lambda prompt=prompt: engine.prefill(prompt))
        prefixes.append(pf)
        prefill_ms.append(ms)
    ops.set_probe(None)
    probe.skip = 0
    caught = {op for op, calls in probe.calls.items()
              if any(k[0] == probe.tag for k in calls)}
    if n_agg and not caught >= set(kernels):
        fail(f"{path}: prefill calls of {sorted(set(kernels) - caught)} not "
             "captured")
    counts = ops.launch_counts()
    jobs[f"{key} prefill"] = {"ms": sum(prefill_ms), "launches": counts}
    per_token = {op: counts[op] / prompts.size for op in kernels}
    print(f"{path}: prefill of {len(prompts)} x {prompts.shape[1]} tokens, "
          f"batch 1: {[round(m, 1) for m in prefill_ms]} ms "
          f"({sum(prefill_ms) / prompts.size:.2f} ms a token), launches a "
          f"token {per_token}")
    if any(n != n_agg for n in per_token.values()):
        fail(f"{path} prefill: {per_token} launches a token, expected one an "
             f"aggregated layer ({n_agg})")
    ops.set_probe(probe)
    for rf in sweep:
        probe.tag = f"{path} rf={rf}"
        lm_generate(torch, engine, prefixes, rf, warm)
    ops.set_probe(None)
    probe.tag = None

    outs, levels = {}, {}
    for rf in sweep:
        before = ops.launch_counts()
        toks, logits, times = lm_generate(torch, engine, prefixes, rf, steps)
        after = ops.launch_counts()
        launches = {op: after[op] - before[op] for op in kernels}
        per_step = {op: n / steps for op, n in launches.items()}
        want = {"distance_topk": n_agg if rf > 0 else 0,
                kernels[1]: n_agg if rf > 0 or layout == "flat" else 0}
        if per_step != want:
            fail(f"{path} rf={rf}: {per_step} launches a step, expected "
                 f"{want}")
        jobs[f"{key} rf={rf}"] = {"ms": sum(times), "launches": launches}
        outs[rf] = (toks, logits)
        worst, cap = lm_max_count(engine)
        q = statistics.quantiles(times, n=100, method="inclusive")
        levels[str(rf)] = {
            "tokens_per_s": steps * LM_SLOTS / sum(times) * 1e3,
            "step_p50_ms": statistics.median(times), "step_p99_ms": q[98],
            "launches": launches, "launches_per_step": per_step,
            "step_bytes": engine.step_bytes(rf),
            "max_bucket_count": worst, "capacity": cap,
        }
    ref_toks, ref_logits = outs[1.0]
    for rf in sweep:
        toks, logits = outs[rf]
        lv = levels[str(rf)]
        lv["kl_vs_rf1"] = lm_kl(torch, ref_logits, logits)
        # the first decode step: the same context at every level
        lv["kl_first_step"] = lm_kl(torch, ref_logits[:, 1], logits[:, 1])
        lv["token_agreement"] = float((toks == ref_toks).float().mean())
        if not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
            fail(f"{path} rf={rf}: non-finite logits")
        print(f"{path} rf={rf}: {lv['tokens_per_s']:.1f} tokens/s, "
              f"step p50 {lv['step_p50_ms']:.2f} ms p99 "
              f"{lv['step_p99_ms']:.2f} ms, KL vs rf 1.0 "
              f"{lv['kl_vs_rf1']:.4g} (first step "
              f"{lv['kl_first_step']:.4g}), agreement "
              f"{lv['token_agreement']:.3f}, launches {lv['launches']} "
              f"({lv['launches_per_step']} a step), "
              f"largest bucket {lv['max_bucket_count']} / {lv['capacity']}")
    summary = {"prefill_ms": prefill_ms,
               "prefill_ms_a_token": sum(prefill_ms) / prompts.size,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "levels": levels}
    print(f"{path}: prefill {summary['prefill_ms_a_token']:.2f} ms a token, "
          f"peak {summary['peak_gib']:.1f} GiB")
    counts = ops.launch_counts()
    if n_agg:
        check_launched(path, counts, kernels)
    return summary, counts


def lm_exact_decode(torch, model_lib, model, cfg, prompt, n_new, *,
                    dev="cuda", s_max=LM_S_MAX):
    """benchmarks/decode_bench.py:_exact_decode: a batch-1 exact-attention
    decode (agg_kv off): the greedy tokens and logits from the prompt's
    last position on."""
    caches = model_lib.init_caches(cfg, batch=1, s_max=s_max, device=dev)
    feed = [int(t) for t in prompt]
    toks, logits = [], []
    for t in range(len(feed) + n_new - 1):
        cur = torch.tensor([[feed[t]]], dtype=torch.int32, device=dev)
        pos = torch.tensor([t], dtype=torch.int32, device=dev)
        lg, caches = model_lib.serve_step(model, caches, cur, pos, cfg)
        if t >= len(prompt) - 1:
            feed.append(int(torch.argmax(lg[0])))
            toks.append(feed[-1])
            logits.append(lg[0].float())
    return torch.tensor(toks, device=dev), torch.stack(logits)


def lm_guard(torch, model_lib, engine_cls, model, cfg, prompts, n_new, *,
             layouts=LM_LAYOUTS, exact="decode", name=f"LM guard {LM_ARCH}",
             dev="cuda", s_max=LM_S_MAX) -> dict:
    """decode_bench's exactness guard on an f32 ``cfg``: at refine_frac 1.0
    the engine's tokens equal the exact path's and its logits agree within
    LM_GUARD_TOL, in each of ``layouts`` (TF32 is off for every f32
    product).  The exact path: for ``exact="decode"`` a batch-1 exact
    decode (agg_kv off: exact attention, or for MLA ``mla_decode`` over the
    latent cache), for ``"forward"`` ``forward`` over each prompt and the
    tokens the engine generated from it."""
    what = {"decode": "exact decode", "forward": "forward"}[exact]
    if exact == "decode":
        ref = [lm_exact_decode(torch, model_lib, model, cfg.with_(agg_kv=False),
                               p, n_new, dev=dev, s_max=s_max)
               for p in prompts]
    out = {}
    for layout in layouts:
        engine = engine_cls(model, cfg.with_(agg_layout=layout),
                            max_slots=len(prompts), s_max=s_max,
                            generator=torch.Generator(dev).manual_seed(7))
        prefixes = [engine.prefill(p) for p in prompts]
        toks, logits, _ = lm_generate(torch, engine, prefixes, 1.0, n_new - 1)
        if exact == "forward":
            ref = []
            for p, t in zip(prompts, toks):
                seq = torch.cat([torch.as_tensor(p, device=dev).long(),
                                 t[:-1].long()])[None]
                lg = model_lib.forward(model, seq, cfg)[0, len(p) - 1:].float()
                ref.append((lg.argmax(-1), lg))
        worst, cap = lm_max_count(engine)
        err = max(float((logits[i] - ex_l).abs().max())
                  for i, (_, ex_l) in enumerate(ref))
        same = all(torch.equal(toks[i].long(), ex_t.long())
                   for i, (ex_t, _) in enumerate(ref))
        close = all(torch.allclose(logits[i], ex_l, rtol=LM_GUARD_TOL,
                                   atol=LM_GUARD_TOL)
                    for i, (_, ex_l) in enumerate(ref))
        print(f"{name} {layout} (f32, {cfg.n_layers} layers, {len(prompts)} "
              f"x {len(prompts[0])}-token prompts, rf 1.0 vs the {what}): "
              f"tokens equal {same}, max logit err {err:.3e} (tol "
              f"{LM_GUARD_TOL}), largest bucket {worst} / {cap}")
        if not (same and close):
            fail(f"{name} {layout}: rf 1.0 decode differs from the {what}")
        out[layout] = {"exact": what, "tokens_equal": same,
                       "max_logit_err": err, "max_bucket_count": worst,
                       "capacity": cap}
    return out


def lm_servable_guard(torch, model_lib, model, cfg) -> dict:
    """The serve phase's LMServable (flat, LM_SERVE_SLOTS slots, its relaxed
    prompts) at a full budget on the guard's f32 model: its tokens equal an
    exact-attention decode's of the same prompts and its logits agree
    within LM_GUARD_TOL."""
    import numpy as np

    from repro_torch.serve.lm import DecodeEngine, LMServable

    engine = DecodeEngine(model, cfg.with_(agg_layout="flat"),
                          max_slots=LM_SERVE_SLOTS, s_max=LM_S_MAX,
                          generator=torch.Generator("cuda").manual_seed(7))
    servable = LMServable(engine, prompt_len=LM_SERVE_PROMPT,
                          max_new_tokens=LM_SERVE_NEW)
    prompts = lm_serve_prompts(cfg.vocab_size)[:LM_SERVE_SLOTS]
    full = servable.run(engine, servable.pad_batch(
        [(p,) for p in prompts], LM_SERVE_SLOTS),
        refine_budget=servable.n_points)
    exact_cfg = cfg.with_(agg_kv=False)
    agree, err = [], 0.0
    for i, p in enumerate(prompts):
        ex_t, ex_l = lm_exact_decode(torch, model_lib, model, exact_cfg, p,
                                     LM_SERVE_NEW)
        ex_l = ex_l.cpu().numpy()
        err = max(err, float(np.abs(full["logits"][i] - ex_l).max()))
        agree.append(np.array_equal(full["tokens"][i], ex_t.cpu().numpy())
                     and np.allclose(full["logits"][i], ex_l,
                                     rtol=LM_GUARD_TOL, atol=LM_GUARD_TOL))
    same = all(agree)
    print(f"LM guard servable (f32, {LM_GUARD_LAYERS} layers, flat, "
          f"{LM_SERVE_SLOTS} x {LM_SERVE_PROMPT}-token prompts, full budget "
          f"{servable.n_points} buckets vs exact attention): tokens and "
          f"logits equal {same}, max logit err {err:.3e} (tol "
          f"{LM_GUARD_TOL})")
    if not same:
        fail("LM guard servable: the full-budget answer differs from exact "
             "attention")
    return {"tokens_and_logits_equal": same, "max_logit_err": err}


def lm_small_check(torch, archs=None, devs=("cuda", "cpu")):
    """The smoke configs of qwen3-8b and of the arch phase's five (or
    ``archs``) in f32 on the card and on the CPU (the plain versions;
    ``devs`` names the two), same weights and LSH draws: one ``forward``
    (whisper with ``frames``, qwen2-vl with a t/h/w grid whose three rows
    differ), then two 6-token prompts through DecodeEngine in the model's
    layouts and 6 decode steps at every refine_frac of LM_SWEEP (1.0 alone
    without aggregated layers): forward logits, tokens and decode logits
    equal within LM_CPU_TOL."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serve.lm.engine import DecodeEngine

    layouts = {LM_ARCH: LM_LAYOUTS,
               **{row.arch: row.layouts for row in DECODE_MODELS}}
    if archs is None:
        archs = (LM_ARCH, *(row.arch for row in DECODE_MODELS
                            if row.phase == "arch"))
    for arch in archs:
        cfg = get_config(arch, smoke=True).with_(agg_kv=True,
                                                 agg_compression=4)
        sweep = LM_SWEEP if n_aggregated(cfg) else (1.0,)
        prompts = lm_prompts(cfg.vocab_size, 2, 6, seed=4)
        tokens = lm_prompts(cfg.vocab_size, 2, 10, seed=8)
        t = np.arange(10)
        grid = np.ascontiguousarray(np.broadcast_to(
            np.stack([t, t // 2, t % 3])[:, None], (3, 2, 10)))
        frames = torch.randn((2, 10, cfg.d_model),
                             generator=torch.Generator().manual_seed(9))
        results = []
        for dev in devs:
            model = model_lib.init_params(
                cfg, torch.Generator().manual_seed(5), device=dev)
            extra = {}
            if cfg.is_encoder_decoder:
                extra["frames"] = frames.to(dev)
            if cfg.mrope:
                extra["mrope_positions"] = torch.as_tensor(grid, device=dev)
            fwd = model_lib.forward(model, torch.as_tensor(tokens, device=dev),
                                    cfg, **extra)
            out = {"forward": (None, fwd.float().cpu())}
            for layout in layouts[arch]:
                lsh = model_lib.draw_lsh(cfg, torch.Generator().manual_seed(6),
                                         device=dev)
                engine = DecodeEngine(model, cfg.with_(agg_layout=layout),
                                      max_slots=2, s_max=32, lsh=lsh)
                prefixes = [engine.prefill(p) for p in prompts]
                for rf in sweep:
                    toks, logits, _ = lm_generate(torch, engine, prefixes, rf,
                                                  6)
                    out[f"{layout} rf={rf}"] = (toks.cpu(), logits.cpu())
            results.append(out)
        worst = {}
        for key, (gt, gl) in results[0].items():
            wt, wl = results[1][key]
            err = (gl - wl).abs()
            worst[key] = float(err.max())
            same = gt is None or torch.equal(gt, wt)
            if not same or bool((err > LM_CPU_TOL + LM_CPU_TOL * wl.abs())
                                .any()):
                fail(f"LM small check {arch} {key}: the card and the CPU "
                     f"differ (tokens equal {same}, max logit err "
                     f"{worst[key]:.3e})")
        print(f"LM small check {arch} (smoke, f32, cuda vs cpu): forward max "
              f"err {worst.pop('forward'):.2e}; 6 decode steps in "
              f"{' and '.join(layouts[arch])} at rf {sweep}: tokens equal, "
              f"max logit err {max(worst.values()):.2e}")


def decode_phase(torch, ops, probe, jobs, phase, *, models=None,
                 dev="cuda", prompt_len=None, guard_prompt=None,
                 s_max=LM_S_MAX):
    """The ``phase`` rows of DECODE_MODELS through DecodeEngine on the LM
    path, each at its published widths and the row's depth (or as the
    config ``models`` gives), each followed by its f32 guard (``prompt_len``
    may cut the path's prompts, ``guard_prompt`` the guards'); returns
    (summary, launch counts summed over the paths)."""
    from repro_torch.configs import get_config, param_count
    from repro_torch.models import model as model_lib
    from repro_torch.serve.lm.engine import DecodeEngine

    t_phase = time.perf_counter()
    summary, total = {}, {}
    for row in DECODE_MODELS:
        if row.phase != phase:
            continue
        t_model = time.perf_counter()
        base = (models or {}).get(row.arch) or get_config(row.arch)
        cfg = base if models else base.with_(n_layers=row.n_layers)
        cfg = cfg.with_(agg_kv=True, agg_compression=LM_COMPRESSION)
        t0 = time.perf_counter()
        model = model_lib.init_params(
            cfg, torch.Generator(dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        kinds = model_lib.block_kinds(cfg)
        n_agg = n_aggregated(cfg)
        print(f"{phase} {row.arch}: {cfg.n_layers} layers "
              f"({ {k: kinds.count(k) for k in dict.fromkeys(kinds)} }, "
              f"{cfg.first_k_dense} dense FFN, {n_agg} aggregated), "
              f"{n_params / 1e9:.3f} B parameters (param_count "
              f"{param_count(cfg) / 1e9:.3f} B before vocab padding), "
              f"{cfg.dtype}, drawn in {time.perf_counter() - t0:.1f} s")
        prompts = lm_prompts(cfg.vocab_size, LM_SLOTS,
                             prompt_len or row.prompt, seed=0)
        summary[row.arch] = {"params": n_params, "layers": cfg.n_layers,
                             "aggregated_layers": n_agg}
        for layout in row.layouts:
            summary[row.arch][layout], counts = lm_path(
                torch, ops, probe, DecodeEngine, model, cfg, layout, prompts,
                jobs, name=f"{phase} {row.arch}",
                sweep=DECODE_SWEEP if n_agg else (1.0,), steps=DECODE_STEPS,
                warm=1, dev=dev, s_max=s_max)
            for op, n in counts.items():
                total[op] = total.get(op, 0) + n
        del model
        gc.collect()
        torch.cuda.empty_cache()
        if row.guard is not None:
            guard = base.with_(**row.guard, dtype="float32", agg_kv=True,
                               agg_compression=LM_COMPRESSION)
            model = model_lib.init_params(
                guard, torch.Generator(dev).manual_seed(3), device=dev)
            summary[row.arch]["guard"] = lm_guard(
                torch, model_lib, DecodeEngine, model, guard,
                lm_prompts(guard.vocab_size, row.guard_prompts,
                           (guard_prompt or {}).get(row.arch,
                                                    row.guard_prompt),
                           seed=1), DECODE_GUARD_NEW,
                layouts=row.layouts, exact=row.exact,
                name=f"{phase} guard {row.arch}", dev=dev, s_max=s_max)
            del model
            gc.collect()
            torch.cuda.empty_cache()
        summary[row.arch]["model_s"] = time.perf_counter() - t_model
    summary["phase_s"] = time.perf_counter() - t_phase
    return summary, total


def lm_phase(torch, ops, probe, jobs):
    """The LM path at qwen3-8b's full width and depth in bf16, both
    layouts; returns (summary, launch counts summed over the layouts, the
    model and its config: the serve phase serves the same weights)."""
    from repro_torch.configs import get_config, param_count
    from repro_torch.models import model as model_lib
    from repro_torch.serve.lm.engine import DecodeEngine

    cfg = get_config(LM_ARCH).with_(agg_kv=True,
                                    agg_compression=LM_COMPRESSION)
    t0 = time.perf_counter()
    model = model_lib.init_params(
        cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"LM {LM_ARCH}: {n_params / 1e9:.3f} B parameters "
          f"(param_count {param_count(cfg) / 1e9:.3f} B before vocab "
          f"padding), {cfg.dtype}, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    prompts = lm_prompts(cfg.vocab_size, LM_SLOTS, LM_PROMPT, seed=0)
    summary, total = {}, {}
    for layout in LM_LAYOUTS:
        summary[layout], counts = lm_path(torch, ops, probe, DecodeEngine,
                                          model, cfg, layout, prompts, jobs)
        for op, n in counts.items():
            total[op] = total.get(op, 0) + n
    return summary, total, model, cfg


def lm_guard_phase(torch):
    """decode_bench's exactness guard (``lm_guard``) at qwen3-8b's full
    width in f32, LM_GUARD_LAYERS deep, on the LM phase's prompts, then
    the serve phase's LMServable on the same model
    (``lm_servable_guard``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serve.lm.engine import DecodeEngine

    cfg = get_config(LM_ARCH).with_(
        n_layers=LM_GUARD_LAYERS, dtype="float32", agg_kv=True,
        agg_compression=LM_COMPRESSION)
    model = model_lib.init_params(
        cfg, torch.Generator("cuda").manual_seed(3), device="cuda")
    prompts = lm_prompts(cfg.vocab_size, LM_SLOTS, LM_PROMPT, seed=0)
    out = lm_guard(torch, model_lib, DecodeEngine, model, cfg, prompts,
                   LM_NEW_TOKENS)
    out["servable"] = lm_servable_guard(torch, model_lib, model, cfg)
    del model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the serving stack
# ---------------------------------------------------------------------------

def _serve_stats(responses, class_of, traces) -> dict:
    """Per SLO class: the latencies' p50 and p99 (ms), the granted eps, the
    deadline-met rate and escalations (first executions only), the cache's
    hit rate and sources, the shuffle bytes, and the p50 and largest of
    each batch's host time outside its runs and of its span over the
    grant's predicted time (per batch, from the span trees: a batch serves
    one class)."""
    from repro_torch.obs.metrics import percentile

    out = {}
    for cls in dict.fromkeys(class_of.values()):
        first = [r for r in responses
                 if class_of[r.rid] == cls and not r.reexecuted]
        every = [r for r in responses if class_of[r.rid] == cls]
        s1 = [r.stage1_latency_s * 1e3 for r in every]
        tot = [r.total_latency_s * 1e3 for r in every]
        out[cls] = {
            "requests": len(first), "reexecutions": len(every) - len(first),
            "stage1_ms": {"p50": percentile(s1, 50),
                          "p99": percentile(s1, 99)},
            "total_ms": {"p50": percentile(tot, 50),
                         "p99": percentile(tot, 99)},
            "eps_mean": statistics.fmean(r.eps_granted for r in first),
            "eps": sorted({r.eps_granted for r in first}),
            "deadline_met_rate": statistics.fmean(
                r.deadline_met for r in first),
            "escalated": sum(r.escalated for r in first),
            "refined": sum(r.refined is not None for r in every),
            "cache_hit_rate": statistics.fmean(r.cache_hit for r in every),
            "cache_sources": {}, "shuffle_bytes": 0, "batches": 0,
            "host_ms": [], "batch_over_predicted": [],
        }
    for root in traces:
        waits = root.find("batcher.wait")
        row = out.get(class_of.get(waits[0].attrs["rid"])) if waits else None
        if row is None:
            continue
        src = root.find("cache.lookup")[0].attrs["source"]
        row["cache_sources"][src] = row["cache_sources"].get(src, 0) + 1
        row["shuffle_bytes"] += root.attrs["shuffle_bytes"]
        row["batches"] += 1
        # the batch's time outside its servable runs (grant, cache lookup,
        # padding, unpacking, bounds, accuracy proxy, responses); of it the
        # fitted model covers the unpacking alone (calibrate times it)
        runs = root.find("stage1") + root.find("stage2.refine")
        row["host_ms"].append(
            (root.duration_s - sum(s.duration_s for s in runs)) * 1e3)
        predicted = root.find("deadline.grant")[0].attrs["predicted_s"]
        if predicted > 0:
            row["batch_over_predicted"].append(root.duration_s / predicted)
    for row in out.values():
        for key in ("host_ms", "batch_over_predicted"):
            xs = row[key]
            row[key] = {"p50": statistics.median(xs), "max": max(xs)} \
                if xs else None
    return out


def _serve_wave(server, kind, payloads, deadline_s, class_name, class_of,
                max_error=None):
    """Submit one wave and drain it: its responses, the re-executions
    included."""
    for p in payloads:
        rid = server.submit(kind, p, deadline_s, max_error=max_error)
        class_of[rid] = class_name
    return server.drain()


def _check_terminal(kind, responses, class_of):
    """Each submitted request has exactly one terminal response (a response
    that is not escalated, or a re-execution), every response a stage-1
    answer, and an escalated first answer its re-execution."""
    terminal = {}
    for r in responses:
        if r.stage1 is None:
            fail(f"serve {kind}: request {r.rid} has no stage-1 answer")
        if not r.escalated or r.reexecuted:
            terminal[r.rid] = terminal.get(r.rid, 0) + 1
            if r.refined is None and r.reexecuted:
                fail(f"serve {kind}: re-execution {r.rid} has no refined "
                     "answer")
    bad = [rid for rid in class_of if terminal.get(rid) != 1]
    if bad:
        fail(f"serve {kind}: {len(bad)} requests without exactly one "
             f"terminal answer (first: {bad[:5]})")


def _same_answers(kind, server, prepared, responses, payload_of) -> list:
    """The server's stage-1 and refined answers of a wave equal, to the
    bit, a direct ``run`` of the same padded batch on the same prepared
    aggregates at the granted budget, batch by batch (re-executions of
    escalated requests included).  Returns the budgets held."""
    import numpy as np

    from repro_torch.core.refine import eps_to_budget
    from repro_torch.serve.scheduler import pad_size

    servable = server.servables[kind]
    budgets, i = [], 0
    while i < len(responses):      # in serving order, a batch at a time
        group = responses[i:i + responses[i].batch_size]
        i += len(group)
        if len({(r.eps_granted, r.reexecuted) for r in group}) != 1:
            fail(f"serve {kind}: one batch, several grants")
        batch = servable.pad_batch(
            [payload_of[r.rid] for r in group],
            pad_size(len(group), server.batcher.pad_sizes))
        budget = eps_to_budget(servable.n_points, group[0].eps_granted)
        outs = {"stage1": 0, "refined": budget} if budget else {"stage1": 0}
        for stage, b in outs.items():
            want = servable.unpack(servable.run(prepared, batch,
                                                refine_budget=b), len(group))
            for r, w in zip(group, want):
                got = getattr(r, stage)
                same = (np.array_equal(got["tokens"], w["tokens"])
                        and np.array_equal(got["logits"], w["logits"])
                        if kind == "lm" else np.array_equal(np.asarray(got),
                                                            np.asarray(w)))
                if not same:
                    fail(f"serve {kind}: request {r.rid}'s {stage} answer "
                         f"differs from a direct run at budget {b}")
        budgets.append(budget)
    if not any(budgets):
        fail(f"serve {kind}: the wave held against a direct run had no "
             "refined answer")
    return budgets


class EventRecorder:
    """Wraps a servable's ``run`` to put CUDA events around each call: the
    card's time of every run ``calibrate`` makes and times itself."""

    def __init__(self, torch, servable):
        self.torch, self.servable, self.run = torch, servable, servable.run
        self.calls = []

    def __enter__(self):
        def run(*args, refine_budget, **kwargs):
            ev = [self.torch.cuda.Event(enable_timing=True) for _ in "se"]
            ev[0].record()
            out = self.run(*args, refine_budget=refine_budget, **kwargs)
            ev[1].record()
            self.calls.append((refine_budget, ev))
            return out
        self.servable.run = run
        return self

    def __exit__(self, *exc):
        del self.servable.run       # the class's run again


def calibrate_covers(server, kind, recorder) -> dict:
    """``calibrate``'s stage-1 time (the fitted model at eps 0: the median
    of its timed runs at eps 0, each on the host clock up to a synchronise,
    and its share of the host term) against the median CUDA-event time of
    the same runs (after a warm-up at each budget, the timed runs alternate
    between eps 0 and eps_max).  Separate runs would not do: the card's
    clock moves between them."""
    from repro_torch.serve.server import CALIBRATE_RUNS

    servable = server.servables[kind]
    ctl = server.controller
    t_eps0 = ctl.models[kind].predict(servable.n_points,
                                      ctl.policy.compression_ratio, 0.0)
    first = recorder.calls[:2 + 2 * CALIBRATE_RUNS]
    timed = [c for c in first[2:] if c[0] == 0]
    if first[0][0] != 0 or len(timed) != CALIBRATE_RUNS:
        fail(f"serve {kind}: calibrate's runs at budget 0 are not every "
             "other one after its two warm-ups")
    card = statistics.median(s.elapsed_time(e) / 1e3 for _, (s, e) in timed)
    if t_eps0 < card:
        fail(f"serve {kind}: calibrate's stage-1 time {t_eps0 * 1e3:.3f} ms "
             f"is below the card's {card * 1e3:.3f} ms for the same runs: it "
             "timed launches, not the work")
    return {"t_eps0_ms": t_eps0 * 1e3, "event_ms": card * 1e3}


def one_slo_class(deadline_s: float) -> float:
    """``deadline_s``, raised where it lies less than SLO_CLASS_MARGIN
    above a power of two to that margin above it: the batcher co-batches
    requests whose remaining budgets share a log2 class, and a wave's first
    requests would otherwise fall into the class below while the wave is
    submitted, splitting it into two batches, the second of which waits
    for the first."""
    floor = 2.0 ** math.floor(math.log2(deadline_s))
    return max(deadline_s, floor * (1.0 + SLO_CLASS_MARGIN))


def slo_classes(server, kind) -> dict:
    """The kind's SLO classes from its fitted model, derived as
    ``prepare_demo_server`` derives them, the tight class at the grid value
    below eps_max, each kept inside one of the batcher's SLO classes
    (``one_slo_class``)."""
    ctl = server.controller
    n = server.servables[kind].n_points
    tight = max(e for e in ctl.eps_grid if e < ctl.policy.eps_max)
    slos = {"relaxed": 1.5 * ctl.deadline_for(kind, n, ctl.policy.eps_max),
            "tight": 1.15 * ctl.deadline_for(kind, n, tight),
            "hopeless": 0.25 * ctl.deadline_for(kind, n, 0.0)}
    return {c: one_slo_class(slos[c]) for c in SERVE_CLASSES[kind]}


def _make_server(servables, kind, batcher, **obs):
    from repro_torch.core.budget import BudgetPolicy
    from repro_torch.serve import DeadlineController, Server

    return Server(servables, controller=DeadlineController(
        BudgetPolicy(**SERVE_POLICY[kind])), batcher=batcher, **obs)


def _observed():
    """A live tracer, a flight recorder, a 1 s rollup and the default SLO
    objectives: what every server of the phase runs under."""
    from repro_torch.obs import FlightRecorder, Tracer, default_objectives

    return dict(tracer=Tracer(), flight=FlightRecorder(capacity=256),
                window_s=1.0, slo_objectives=default_objectives())


def _check_exports(kind, server):
    """The metrics snapshot, the trace and the flight recorder's export
    pass their schemas, and the recorder holds every escalated batch."""
    from repro_torch.obs import (
        validate_flight_jsonl, validate_snapshot, validate_trace_jsonl,
    )

    problems = validate_snapshot(server.metrics.snapshot())
    problems += validate_trace_jsonl(server.tracer.to_jsonl())
    problems += validate_flight_jsonl(server.flight.to_jsonl())
    if problems:
        fail(f"serve {kind}: exports fail their schemas: {problems[:3]}")
    kept = {id(e.root) for e in server.flight.entries()}
    escalated = [root for root in server.tracer.traces()
                 if root.find("deadline.grant")[0].attrs["escalate"]]
    if any(id(root) not in kept for root in escalated):
        fail(f"serve {kind}: the flight recorder lost an escalated batch")
    return {"flight_entries": len(server.flight),
            "flight_reasons": sorted({e.reason for e in
                                      server.flight.entries()}),
            "escalated_batches": len(escalated),
            "spans": sum(1 for root in server.tracer.traces()
                         for _ in root.walk())}


def _probe_wave(ops, server, kind, payloads, deadline_s, class_of):
    """One wave under ``install_kernel_probe``: its calls per op equal the
    kernels' launches over the same wave.  Returns (summary, responses)."""
    from repro_torch.obs import (
        MetricsRegistry, install_kernel_probe, uninstall_kernel_probe,
    )

    before = ops.launch_counts()
    probe = install_kernel_probe(MetricsRegistry())
    try:
        out = _serve_wave(server, kind, payloads, deadline_s, "probe",
                          class_of)
    finally:
        uninstall_kernel_probe()
    after = ops.launch_counts()
    launched = {op: after[op] - before[op] for op in after
                if after[op] > before[op]}
    if probe.calls() != launched:
        fail(f"serve {kind}: the probe counted {probe.calls()}, the kernels "
             f"launched {launched}")
    return {"calls": probe.calls(), "summary": probe.summary()}, out


def _servable(torch, kind, app, data, store=None):
    """The kind's servable over a whole dataset on its device."""
    dev = data[0].device
    seed = torch.Generator(dev).manual_seed(SERVE_SEED + (kind == "cf"))
    if kind == "knn":
        return app.KNNServable(data[0], data[1], n_classes=N_CLASSES, k=K,
                               lsh_generator=seed, store=store, device=dev)
    return app.CFServable(data[0], data[1], lsh_generator=seed, store=store,
                          device=dev)


def _serve_lsh_kind(torch, ops, probe, server, kind, payloads,
                    card_grants=True):
    """Calibrate, freeze the correction, prewarm every pad size, reset the
    meters (``prepare_demo_server``'s steps), then the waves of each SLO
    class, a kNN wave with a loose max_error, a probed wave and a captured
    one whose answers are held against a direct run; returns the kind's
    summary and its responses.  ``card_grants`` holds the relaxed class's
    grants (SERVE_KEEPS_EPS_MAX), which only the card's timings can
    show."""
    import random

    servable = server.servables[kind]
    t0 = time.perf_counter()
    with EventRecorder(torch, servable) as recorder:
        server.calibrate(kind)
    server.controller.ema = 0.0
    server.prewarm(kind)
    server.reset_metrics()
    slos = slo_classes(server, kind)
    prep_s = time.perf_counter() - t0
    pick = random.Random(SERVE_SEED)
    payload_of, class_of, responses = {}, {}, []

    def wave(cls, max_error=None):
        chosen = [payloads[i] for i in pick.sample(range(len(payloads)),
                                                   SERVE_BATCH)]
        # the loose max_error wave: four times the relaxed deadline, so that
        # only the accuracy SLO decides whether stage 2 runs
        deadline = slos.get(cls, (4.0 if max_error else 1.0)
                            * slos["relaxed"])
        before = set(class_of)
        out = _serve_wave(server, kind, chosen, deadline, cls, class_of,
                          max_error)
        for rid, p in zip(sorted(set(class_of) - before), chosen):
            payload_of[rid] = p
        responses.extend(out)
        return out

    for _ in range(SERVE_WAVES):
        for cls in slos:
            wave(cls)
    loose = wave("loose max_error", SERVE_LOOSE_ERROR) if kind == "knn" \
        else []
    chosen = [payloads[i] for i in pick.sample(range(len(payloads)),
                                               SERVE_BATCH)]
    probed, out = _probe_wave(ops, server, kind, chosen, slos["relaxed"],
                              class_of)
    responses.extend(out)
    probe.tag = f"serve {kind}"
    ops.set_probe(probe)
    checked = wave("checked")
    ops.set_probe(None)
    probe.tag = None
    summary = {"slo_s": slos, "prepare_s": prep_s,
               "model": dataclasses.asdict(server.controller.models[kind]),
               "correction": server.controller.correction(kind),
               "probe": probed}

    # ---- checks ----
    _check_terminal(kind, responses, class_of)
    stats = _serve_stats(responses, class_of, server.tracer.traces())
    if stats["relaxed"]["eps_mean"] < stats["tight"]["eps_mean"]:
        fail(f"serve {kind}: relaxed mean eps {stats['relaxed']['eps_mean']} "
             f"below tight {stats['tight']['eps_mean']}")
    relaxed = stats["relaxed"]
    eps_max = server.controller.policy.eps_max
    if card_grants and (relaxed["escalated"] or (
            kind in SERVE_KEEPS_EPS_MAX and relaxed["eps"] != [eps_max])):
        fail(f"serve {kind}: the relaxed class escalated or (kNN) was cut "
             f"below eps_max {eps_max}: eps {relaxed['eps']}, "
             f"{relaxed['escalated']} escalated, correction "
             f"{server.controller.correction(kind)}, batch / predicted "
             f"{relaxed['batch_over_predicted']}")
    if "hopeless" in stats:
        h = stats["hopeless"]
        if h["escalated"] != h["requests"] or h["reexecutions"] != \
                h["requests"]:
            fail(f"serve {kind}: hopeless requests escalated {h['escalated']}"
                 f" and re-executed {h['reexecutions']} of {h['requests']}")
    granted = [r for r in loose if not r.escalated and not r.reexecuted]
    if kind == "knn" and (not granted or not all(
            r.refine_skipped and r.refined is None and r.accuracy_met
            for r in granted)):
        fail(f"serve {kind}: the loose max_error wave did not skip stage 2 "
             "(escalated, re-executed, skipped, met, eps: "
             + str(sorted({(r.escalated, r.reexecuted, r.refine_skipped,
                            r.accuracy_met, r.eps_granted) for r in loose}))
             + ")")
    cache = server.cache.stats()
    if cache["misses"]:
        fail(f"serve {kind}: {cache['misses']} cache misses after prewarm")
    prepared = servable.build(server.controller.policy.compression_ratio)
    summary["checked_budgets"] = _same_answers(kind, server, prepared,
                                               checked, payload_of)
    summary["calibrate"] = calibrate_covers(server, kind, recorder)
    summary["exports"] = _check_exports(kind, server)
    summary["classes"] = stats
    summary["cache"] = server.cache.stats()
    summary["summary"] = server.summary()
    return summary


def _warm_start(torch, knn, server, data, payloads) -> dict:
    """save_aggregates, then a fresh kNN server over the same data whose
    warm_start makes its first request a cache hit on restored levels, with
    the saved server's bits."""
    import tempfile

    from repro_torch.serve import ContinuousBatcher

    old = server.servables["knn"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        n_saved = server.save_aggregates(Path(tmp) / "agg")
        save_ms = _ms_since(torch, t0)
        fresh = _make_server([_servable(torch, "knn", knn, data)], "knn",
                             ContinuousBatcher(max_batch=SERVE_BATCH))
        fresh.controller.set_model("knn", server.controller.models["knn"])
        fresh.controller.ema = 0.0
        t0 = time.perf_counter()
        warmed = fresh.warm_start(Path(tmp) / "agg")
        restore_ms = _ms_since(torch, t0)
    if n_saved != 1 or warmed != {"restored": 1, "warmed": 1}:
        new = fresh.servables["knn"]
        fail(f"serve warm start: saved {n_saved}, warm_start {warmed} (same "
             f"data fingerprint {new._fingerprint == old._fingerprint}, "
             f"same draws {new._lsh_key_data == old._lsh_key_data})")
    batch = payloads[:SERVE_BATCH]
    t0 = time.perf_counter()
    rids = [fresh.submit("knn", p, 60.0) for p in batch]
    out = fresh.drain()
    first_ms = _ms_since(torch, t0)
    if [r.rid for r in out] != rids or not all(r.cache_hit for r in out):
        fail("serve warm start: the first requests were not cache hits")
    cache = fresh.cache.stats()
    if cache["restored_hits"] != 1 or cache["misses"]:
        fail(f"serve warm start: cache {cache}, expected one restored entry "
             "and no miss")
    prepared = old.build(server.controller.policy.compression_ratio)
    _same_answers("knn", fresh, prepared, out, dict(zip(rids, batch)))
    return {"save_ms": save_ms, "restore_ms": restore_ms,
            "first_answer_ms": first_ms, "saved": n_saved, **warmed,
            "cache": cache, "store": fresh.servables["knn"].store.stats()}


def _front_door(server, payloads) -> dict:
    """Two tenants before the kNN server through the worker thread: ``a``
    unlimited, ``b`` at 20/s with a burst of 4; each sends DOOR_BURST."""
    from repro_torch.serve import FrontDoor, Overloaded, Response, TenantSpec

    door = FrontDoor(
        server, tenants=[TenantSpec("a"), TenantSpec("b", **DOOR_B)],
        default_deadline_s=60.0, queue_limit=4 * DOOR_BURST)
    door.start()
    try:
        rids = {t: [door.submit("knn", payloads[i], tenant=t)
                    for i in range(DOOR_BURST)] for t in ("b", "a")}
        got = {t: [door.wait(rid, timeout_s=300.0) for rid in rs]
               for t, rs in rids.items()}
    finally:
        door.stop()
    refused = [r for r in got["b"] if isinstance(r, Overloaded)]
    if not refused or not all(r.reason == "quota" and r.retry_after_s > 0
                              for r in refused):
        fail(f"serve front door: tenant b's excess was not refused with "
             f"Overloaded and a retry_after_s > 0 ({len(refused)} refused)")
    answered = [r for t in got for r in got[t]
                if isinstance(r, Response)]
    for t in got:
        for rid, r in zip(rids[t], got[t]):
            if r is None or r.rid != rid:
                fail(f"serve front door: tenant {t}'s request {rid} was "
                     "not answered")
    if any(isinstance(r, Overloaded) for r in got["a"]):
        fail("serve front door: the unlimited tenant was refused")
    stats = door.stats()
    if stats["pending_results"] or stats["admitted"] != len(answered):
        fail(f"serve front door: {stats}")
    return stats


def lm_serve_prompts(vocab: int):
    """The LM server's prompts: a relaxed and a tight wave's."""
    import numpy as np

    return lm_prompts(vocab, 2 * LM_SERVE_SLOTS, LM_SERVE_PROMPT,
                      seed=5).astype(np.int32)


def _lm_serve(torch, ops, probe, model, cfg) -> dict:
    """The LM server: calibrate at batch 1 (no prewarm: there is nothing
    to build), then a relaxed and a tight wave of LM_SERVE_SLOTS prompts.
    The relaxed wave's kernel calls are captured (cloned: the caches change
    in place) for the kernel rows, and its answers are held against a
    direct run.  (Its full-budget answer is held against exact attention
    by ``lm_servable_guard``, in f32.)"""
    from repro_torch.serve import ContinuousBatcher
    from repro_torch.serve.lm import DecodeEngine, LMServable, lm_pad_sizes

    engine = DecodeEngine(model, cfg.with_(agg_layout="flat"),
                          max_slots=LM_SERVE_SLOTS, s_max=LM_S_MAX,
                          generator=torch.Generator(model.embed.device)
                          .manual_seed(7))
    servable = LMServable(engine, prompt_len=LM_SERVE_PROMPT,
                          max_new_tokens=LM_SERVE_NEW)
    server = _make_server([servable], "lm", ContinuousBatcher(
        max_batch=LM_SERVE_SLOTS, pad_sizes=lm_pad_sizes(LM_SERVE_SLOTS)),
        **_observed())
    t0 = time.perf_counter()
    server.calibrate("lm", batch=1)
    server.controller.ema = 0.0
    server.reset_metrics()
    prep_s = time.perf_counter() - t0
    slos = slo_classes(server, "lm")
    prompts = lm_serve_prompts(cfg.vocab_size)
    lm_probe = CaptureProbe(torch, clone=True)
    run = servable.run

    def tagged_run(prepared, batch, *, refine_budget):
        # a capture key per pass: stage 1 and the refined pass call the
        # decode kernels at the same shapes
        lm_probe.tag = f"serve lm budget {refine_budget}"
        return run(prepared, batch, refine_budget=refine_budget)

    class_of, payload_of, responses = {}, {}, []
    for i, cls in enumerate(SERVE_CLASSES["lm"]):
        chosen = [(p,) for p in prompts[i * LM_SERVE_SLOTS:
                                        (i + 1) * LM_SERVE_SLOTS]]
        before = set(class_of)
        if cls == "relaxed":
            ops.set_probe(lm_probe)
            servable.run = tagged_run
        try:
            responses += _serve_wave(server, "lm", chosen, slos[cls], cls,
                                     class_of)
        finally:
            ops.set_probe(None)
            vars(servable).pop("run", None)   # the class's run again
        payload_of.update(zip(sorted(set(class_of) - before), chosen))
    missing = {"distance_topk", "aggregated_attention_decode"} - set(
        lm_probe.calls)
    if missing:
        fail(f"serve lm: the relaxed wave's calls of {sorted(missing)} "
             "were not captured")
    for op, calls in lm_probe.calls.items():
        probe.calls.setdefault(op, {}).update(calls)
    _check_terminal("lm", responses, class_of)
    stats = _serve_stats(responses, class_of, server.tracer.traces())
    if stats["relaxed"]["eps_mean"] < stats["tight"]["eps_mean"]:
        fail(f"serve lm: relaxed mean eps {stats['relaxed']['eps_mean']} "
             f"below tight {stats['tight']['eps_mean']}")
    relaxed = [r for r in responses if class_of[r.rid] == "relaxed"]
    budgets = _same_answers("lm", server, engine, relaxed, payload_of)
    return {"slo_s": slos, "prepare_s": prep_s,
            "model": dataclasses.asdict(server.controller.models["lm"]),
            "classes": stats, "exports": _check_exports("lm", server),
            "summary": server.summary(), "checked_budgets": budgets,
            "captured": {op: len(c) for op, c in lm_probe.calls.items()}}


def serve_phase(torch, knn, cf, ops, probe, knn_data, cf_data, lm_model,
                lm_cfg, card_grants=True):
    """The serving stack on the card: kNN, CF and LM servers through the
    port's Server, then the warm start and the front door; returns
    (summary, the path's launch counts).  ``card_grants=False`` leaves out
    the one check that needs the card's timings (the relaxed class's
    grants): for a rehearsal on the CPU with plain versions."""
    from repro_torch.serve import ContinuousBatcher
    from repro_torch.store import AggregateStore

    t_phase = time.perf_counter()
    train_x, train_y, test_x, _ = knn_data
    nr, nm, a, am = cf_data[:4]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()

    store = AggregateStore()      # kNN and CF share it
    knn_payloads = [(q,) for q in test_x]
    servers, out = {}, {}
    for kind, app, data, payloads in (
            ("knn", knn, (train_x, train_y), knn_payloads),
            ("cf", cf, (nr, nm), [(a[i], am[i]) for i in range(a.shape[0])])):
        servers[kind] = _make_server(
            [_servable(torch, kind, app, data, store)], kind,
            ContinuousBatcher(max_batch=SERVE_BATCH), **_observed())
        out[kind] = _serve_lsh_kind(torch, ops, probe, servers[kind], kind,
                                    payloads, card_grants)
        if kind == "knn":
            # saved before CF builds its pyramid in the shared store: the
            # snapshot holds the kNN pyramid alone
            out["warm_start"] = _warm_start(torch, knn, servers["knn"],
                                            (train_x, train_y), knn_payloads)
    out["lm"] = _lm_serve(torch, ops, probe, lm_model, lm_cfg)
    out["front_door"] = _front_door(servers["knn"], knn_payloads)
    counts = ops.launch_counts()
    out["store"] = store.stats()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    return out, counts


def print_serve(summary):
    """The serve phase's lines: per kind the fitted CostModel and, per SLO
    class, the latencies, granted eps, deadline-met rate, cache and
    shuffle bytes; the warm start, the front door, the peak memory."""
    for kind in ("knn", "cf", "lm"):
        k = summary[kind]
        print(f"serve {kind}: CostModel {k['model']}, prepared in "
              f"{k['prepare_s']:.1f} s; SLO classes "
              + ", ".join(f"{c} {v * 1e3:.2f} ms" for c, v in
                          k["slo_s"].items()))
        for cls, st in k["classes"].items():
            print(f"serve {kind} {cls}: {st['requests']} requests "
                  f"(+{st['reexecutions']} re-executions) in "
                  f"{st['batches']} batches; stage-1 p50 "
                  f"{st['stage1_ms']['p50']:.2f} ms p99 "
                  f"{st['stage1_ms']['p99']:.2f} ms, total p50 "
                  f"{st['total_ms']['p50']:.2f} ms p99 "
                  f"{st['total_ms']['p99']:.2f} ms; eps granted mean "
                  f"{st['eps_mean']:.4g} {st['eps']}; deadline met "
                  f"{st['deadline_met_rate']:.3f}; escalated "
                  f"{st['escalated']}; cache hit rate "
                  f"{st['cache_hit_rate']:.3f} {st['cache_sources']}; "
                  f"shuffle bytes {st['shuffle_bytes']}; host ms a batch "
                  f"outside the runs {st['host_ms']}; batch span / predicted "
                  f"{st['batch_over_predicted']}")
        if "calibrate" in k:
            print(f"serve {kind}: calibrate's stage-1 "
                  f"{k['calibrate']['t_eps0_ms']:.3f} ms >= the card's "
                  f"{k['calibrate']['event_ms']:.3f} ms; probe calls "
                  f"{k['probe']['calls']} = launches; cache {k['cache']}")
        print(f"serve {kind}: a wave against a direct run at budgets "
              f"{k['checked_budgets']}: the same bits"
              + (f"; kernel calls captured {k['captured']}"
                 if "captured" in k else ""))
        print(f"serve {kind}: exports valid, {k['exports']}")
    w = summary["warm_start"]
    print(f"serve warm start: save {w['save_ms']:.1f} ms, warm_start "
          f"{w['restore_ms']:.1f} ms, first answer {w['first_answer_ms']:.1f}"
          f" ms (a cache hit, the saved server's bits); cache {w['cache']}")
    print(f"serve front door stats(): {summary['front_door']}")
    print(f"serve phase: {summary['phase_s']:.1f} s, peak "
          f"{summary['peak_gib']:.1f} GiB allocated "
          f"(torch.cuda.max_memory_allocated)")


# ---------------------------------------------------------------------------
# the runtime: the kNN data in failure domains behind a Server
# ---------------------------------------------------------------------------

def _p50(values) -> float | None:
    return statistics.median(values) if values else None


def fleet_phase(torch, ops, probe, knn_data, *, batch=FLEET_BATCH):
    """``sharded_knn`` over the kNN data, whole, in N_SHARDS failure
    domains on one AggregateStore, behind a ``Server``, through a
    ChaosInjector schedule (FLEET_PLAN: a kill, a slowed shard, a kill
    whose recovery finds the snapshot corrupt).  The first healthy wave
    and the first partial one run with ``probe`` on, tagged "fleet", so
    that the kernels' rows check the domains' stage 1 and stage 2 and both
    merges (all eight domains, and the seven live ones) at the shapes this
    path gives them.  Returns (summary, launch counts of the path).  The
    checks, made after the counts are read: one
    terminal answer a request; ``partial_shards`` (FLEET_KILLED,) on each
    batch while that shard is dead and () otherwise; every run's merged
    output (top-k distances, labels, votes, bounds) the bits of
    ``merge_topk`` and ``majority_vote`` over the live shards' direct
    ``KNNServable.run`` at the same budget, so the recovered waves have the
    full fleet's bits; recoveries ``restored`` then ``rebuilt``; the slowed
    shard hedged and the hedge won; each merge one ``candidate_topk``
    launch."""
    import tempfile

    from repro_torch.apps import knn
    from repro_torch.core.budget import BudgetPolicy, CostModel
    from repro_torch.obs.metrics import default_registry
    from repro_torch.runtime import ChaosInjector, sharded_knn
    from repro_torch.serve import ContinuousBatcher, DeadlineController, Server

    t_phase = time.perf_counter()
    train_x, train_y, test_x, test_y = knn_data
    dev = train_x.device
    snap = tempfile.TemporaryDirectory()
    chaos = ChaosInjector(seed=FLEET_SEED)
    fleet = sharded_knn(
        train_x, train_y, n_shards=N_SHARDS, n_classes=N_CLASSES, k=K,
        lsh_generators=[torch.Generator(dev).manual_seed(s)
                        for s in range(N_SHARDS)],
        chaos=chaos, recovery_batches=FLEET_RECOVERY_RUNS,
        max_slow_sleep_s=FLEET_MAX_STALL_S, snapshot_dir=snap.name,
        device=dev)
    ctl = DeadlineController(BudgetPolicy(**SERVE_POLICY["knn"]), ema=0.0)
    # Every batch priced far inside its deadline: the grant is eps_max and
    # the deadline leaves the hedge its room; the shards' timeout (0.35 of
    # it) is never reached, so no shard's budget is scaled down.
    ctl.set_model("knn", CostModel(c_fixed=0.0, c_stage1=0.0, c_stage2=1e-9))
    server = Server([fleet], controller=ctl, batcher=ContinuousBatcher(
        max_batch=batch, pad_sizes=(batch,)))

    runs, merges, restore_ms = [], [], []
    run, merge = fleet.run, fleet.merge_fn

    def recorded_run(prepared, payload, *, refine_budget):
        out = run(prepared, payload, refine_budget=refine_budget)
        runs.append({"step": fleet.step - 1, "budget": refine_budget,
                     "prepared": prepared, "payload": payload, "out": out,
                     "partial": fleet.last_partial_shards,
                     "status": {r["shard"]: r["status"]
                                for r in fleet.last_reports}})
        return out

    def counted_merge(outs):
        before = ops.launch_counts()["candidate_topk"]
        out = merge(outs)
        merges.append(ops.launch_counts()["candidate_topk"] - before)
        return out

    store = fleet.shared_store()
    restore = store.restore

    def timed_restore(directory, servables):
        t0 = time.perf_counter()
        n = restore(directory, servables)
        restore_ms.append(_ms_since(torch, t0))
        return n

    fleet.run, fleet.merge_fn, store.restore = (recorded_run, counted_merge,
                                                timed_restore)
    outcomes = default_registry().counter("runtime_shard_recoveries_total",
                                          labels=("outcome",))
    before = {o: outcomes.labels(outcome=o).value
              for o in ("restored", "rebuilt")}
    payloads = [(test_x[i],) for i in range(batch)]
    waves, kills, save = [], 0, {}
    to_capture = {"healthy", "partial"}
    ops.set_probe(None)
    ops.reset_launch_counts()
    for kind in FLEET_PLAN:
        if kind == "kill":
            chaos.kill(FLEET_KILLED, fleet.step)
            kills += 1
            if kills == 2:    # this recovery finds the snapshot corrupt
                chaos.corrupt_snapshot(FLEET_KILLED,
                                       fleet.step + FLEET_RECOVERY_RUNS)
        elif kind == "slow":   # in stage 2, the longer run
            chaos.slow(FLEET_SLOWED, fleet.step + 1,
                       factor=FLEET_SLOW_FACTOR)
        first = len(runs)
        captured = kind in to_capture
        if captured:
            to_capture.discard(kind)
            probe.tag = "fleet"
            ops.set_probe(probe)
        rids = [server.submit("knn", p, FLEET_DEADLINE_S) for p in payloads]
        t0 = time.perf_counter()
        responses = server.drain()
        if captured:
            ops.set_probe(None)
            probe.tag = None
        waves.append({"kind": kind, "ms": _ms_since(torch, t0), "rids": rids,
                      "responses": responses, "runs": runs[first:]})
        if kind == "warm":   # the snapshot the recoveries read
            t0 = time.perf_counter()
            save["pyramids"] = fleet.save_snapshot(snap.name)
            save["ms"] = _ms_since(torch, t0)
    counts = ops.launch_counts()
    save["bytes"] = sum(p.stat().st_size for p in Path(snap.name).rglob("*")
                        if p.is_file())

    # ---- checks ----
    summary = fleet.summary()
    dead = ("kill", "partial")
    for i, w in enumerate(waves):
        got = sorted(r.rid for r in w["responses"])
        if got != sorted(w["rids"]) or any(r.reexecuted
                                           for r in w["responses"]):
            fail(f"fleet wave {i} ({w['kind']}): {len(got)} answers for "
                 f"{len(w['rids'])} requests, or a re-execution")
        want = (FLEET_KILLED,) if w["kind"] in dead else ()
        bad = {r.partial_shards for r in w["responses"]} - {want}
        if bad or any(r["partial"] != want for r in w["runs"]):
            fail(f"fleet wave {i} ({w['kind']}): partial_shards {bad}, "
                 f"expected {want}")
        if len(w["runs"]) != 2:
            fail(f"fleet wave {i}: {len(w['runs'])} runs, expected stage 1 "
                 "and stage 2")
    if summary["eps_scale"] != [1.0] * N_SHARDS:
        fail(f"fleet: a shard's budget was scaled: {summary['eps_scale']}")
    if summary["kills"] != 2 or summary["recoveries"] != 2:
        fail(f"fleet: {summary['kills']} kills, {summary['recoveries']} "
             "recoveries, expected 2 and 2")
    got_outcomes = {o: outcomes.labels(outcome=o).value - before[o]
                    for o in before}
    if got_outcomes != {"restored": 1, "rebuilt": 1}:
        fail(f"fleet: recoveries by outcome {got_outcomes}, expected one "
             "restored and one rebuilt")
    slow = next(w for w in waves if w["kind"] == "slow")
    if slow["runs"][1]["status"].get(FLEET_SLOWED) != "hedged" \
            or summary["hedge_wins"] < 1:
        fail(f"fleet: the slowed shard was not hedged, or the hedge lost: "
             f"{slow['runs'][1]['status']}, {summary}")
    if set(merges) != {1}:
        fail(f"fleet: candidate_topk launches a merge {merges}, expected 1")
    prepared = waves[1]["runs"][0]["prepared"]
    payload = waves[1]["runs"][0]["payload"]
    alive = {False: list(range(N_SHARDS)),
             True: [s for s in range(N_SHARDS) if s != FLEET_KILLED]}
    direct = {}
    for w in waves:
        for r in w["runs"]:
            key = (r["budget"], bool(r["partial"]))
            if key not in direct:
                direct[key] = merge([fleet.shards[s].run(
                    prepared[s], payload, refine_budget=r["budget"])
                    for s in alive[key[1]]])
            same = all(torch.equal(a, b) for a, b in zip(r["out"],
                                                         direct[key]))
            if not same:
                fail(f"fleet wave {w['kind']} step {r['step']} budget "
                     f"{r['budget']}: the merged output is not the bits of "
                     "the live shards' direct runs")
    snap.cleanup()
    acc = [knn.accuracy(torch.tensor([r.answer for r in sorted(
        w["responses"], key=lambda r: r.rid)]), test_y[:batch])
        for w in waves if w["kind"] == "healthy"]
    ms = {kind: [w["ms"] for w in waves if w["kind"] in kinds] for kind, kinds
          in (("healthy", ("healthy",)), ("partial", dead),
              ("hedged", ("slow",)), ("recovering", ("restored", "rebuilt")))}
    out = {
        "batch_ms_p50": {k: _p50(v) for k, v in ms.items()},
        "batch_ms": ms, "waves": [w["kind"] for w in waves],
        "kills": summary["kills"], "recoveries": got_outcomes,
        "hedges": summary["hedges"], "hedge_wins": summary["hedge_wins"],
        "snapshot": {**save, "restore_ms": restore_ms},
        "budgets": sorted({k[0] for k in direct}),
        "merges": len(merges), "healthy_accuracy": acc,
        "phase_s": time.perf_counter() - t_phase,
    }
    return out, counts


def print_fleet(summary, smi):
    p50 = summary["batch_ms_p50"]
    print(f"fleet: batch p50 healthy {p50['healthy']:.2f} ms, partial "
          f"{p50['partial']:.2f} ms, hedged {p50['hedged']:.2f} ms, "
          f"recovering (restored, rebuilt) {summary['batch_ms']['recovering']}"
          f" ms; kills "
          f"{summary['kills']}, recoveries {summary['recoveries']}, hedges "
          f"{summary['hedges']} (won {summary['hedge_wins']}); snapshot "
          f"save {summary['snapshot']['ms']:.1f} ms "
          f"({summary['snapshot']['bytes']} bytes), restore "
          f"{summary['snapshot']['restore_ms']} ms; every run the bits of "
          f"its live shards' direct runs at budgets {summary['budgets']}; "
          f"{summary['merges']} merges of one candidate_topk launch each; "
          f"{summary['phase_s']:.1f} s; card: {smi}")


# ---------------------------------------------------------------------------
# the mesh path: 8 ranks on the one card under gloo
# ---------------------------------------------------------------------------

MESH_RANKS = 8
MESH_TIMEOUT_S = 480.0
CF_MESH_USERS = 48_016        # 48,019 does not divide by 8: 3 users cut
EP_ARCH = "moonshot-v1-16b-a3b"
EP_MESH = (2, 4)              # data x model
EP_TOKENS = (2, 256)          # [B, S]: B over data, S over model
EP_TOL = 2e-4                 # f32, tests/_subproc/multidevice_checks.py
A2A_TOL = 2e-2                # bf16 dispatch buffers, the same check
PIPE = {"stages": 4, "d": 4096, "micro": 8, "rows": 64}
PIPE_TOL = 1e-4               # the reference check's gradient tolerance
MESH_TRAIN = {"arch": "qwen3-8b", "steps": 4, "batch": 4, "seq": 64}
MESH_TRAIN_TOL = 1e-5
MESH_KERNELS = ("distance_topk", "candidate_topk", "knn_distance",
                "refine_distances", "lsh_hash", "cf_weights", "cf_refine",
                "cf_aggregate")


def _mesh_sync(torch, dev):
    import torch.distributed as dist

    if dev.type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()


def _within(torch, got, want, tol) -> tuple[bool, float]:
    """(every entry within rtol = atol = tol, the largest abs error)."""
    err = (got.float() - want.float()).abs()
    return (bool((err <= tol + tol * want.float().abs()).all()),
            float(err.max()))


def _moe_view(torch, weights, dev, rows=None):
    """The MoE weights (a dict of host tensors) on ``dev``, the experts'
    ``rows`` only where given."""
    import types

    def on(name):
        t = weights[name]
        return (t if rows is None or not name.startswith("w_")
                else t[rows]).to(dev)

    return types.SimpleNamespace(
        router=on("router"), w_gate=on("w_gate"), w_up=on("w_up"),
        w_down=on("w_down"), shared=types.SimpleNamespace(
            **{k: weights[f"shared.{k}"].to(dev)
               for k in ("w_gate", "w_up", "w_down")}))


def mesh_rank(rank: int, job: dict) -> dict:
    """One rank of the mesh phase (``run_ranks``): every job of
    ``mesh_phase``'s docstring, timed between barriers.  Returns its
    outputs, checks, times, launches and peak memory."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch import optim
    from repro_torch.apps import cf, knn
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core import engine, lsh
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe
    from repro_torch.models.transformer import (
        ParallelContext, _moe_ep_sharded,
    )
    from repro_torch.parallel import pipeline_parallel, sharding

    dev = (torch.device("cuda", torch.cuda.current_device())
           if job["dev"] == "cuda" else torch.device("cpu"))
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    n = job["ranks"]
    out = {"ms": {}}

    def timed(name, fn):
        _mesh_sync(torch, dev)
        t0 = time.perf_counter()
        res = fn()
        _mesh_sync(torch, dev)
        out["ms"][name] = (time.perf_counter() - t0) * 1e3
        return res

    # ---- kNN: 8 map shards, all_gather, merge_topk, majority_vote ----
    mesh = mesh_lib.make_host_mesh((n,), ("data",), device=job["dev"])
    r = mesh.get_local_rank(0)
    ops.reset_launch_counts()
    x = engine.shard_leading(mesh, "data", job["knn_x"])
    y = engine.shard_leading(mesh, "data", job["knn_y"])
    q = job["q"].to(dev)
    n_s = x.to_local().shape[0]
    a, b = job["knn_draws"][r]
    params = lsh.LSHParams(a=a.to(dev), b=b.to(dev),
                           config=lsh.config_for_compression(n_s, RATIO))

    def reduce_fn(g):
        d, lab = knn.merge_topk(g[0], g[1], K)
        return (d, lab, knn.majority_vote(d, lab, N_CLASSES),
                g[2].max(0).values)

    out["knn"] = {}
    for eps, budget in job["knn_budgets"].items():
        eng = engine.MapReduce(mesh)
        res = timed(f"knn eps={eps}", lambda: eng.run(
            partial(knn_mesh_map, knn, params=params, q=q, budget=budget),
            engine.CombineSpec("all_gather", reduce_fn), x, y))
        out["knn"][eps] = {"out": [t.cpu() for t in res],
                           "shuffle": eng.last_shuffle_bytes}
    del x, y

    # ---- CF: one accurateml_map with_bound batch, psum ----
    cr = engine.shard_leading(mesh, "data", job["cf_r"])
    cm = engine.shard_leading(mesh, "data", job["cf_m"])
    ca, cam = job["cf_a"].to(dev), job["cf_am"].to(dev)
    a, b = job["cf_draws"][r]
    cparams = lsh.LSHParams(a=a.to(dev), b=b.to(dev),
                            config=lsh.config_for_compression(
                                cr.to_local().shape[0], CF_RATIO,
                                n_hashes=4, bucket_width=8.0))
    eng = engine.MapReduce(mesh)
    res = timed("cf psum", lambda: eng.run(
        partial(cf_mesh_map, cf, params=cparams, a=ca, am=cam,
                budget=job["cf_budget"]),
        engine.CombineSpec("psum"), cr, cm))
    out["cf"] = {"out": [t.cpu() for t in res],
                 "shuffle": eng.last_shuffle_bytes}
    out["launches"] = ops.launch_counts()
    del cr, cm, ca, cam, res

    # ---- expert parallelism: a (2, 4) data x model mesh ----
    mesh24 = mesh_lib.make_host_mesh(EP_MESH, ("data", "model"),
                                     device=job["dev"])
    cfg = job["ep_cfg"]
    ctx = ParallelContext(mesh=mesh24, data_axes=("data",), use_ep=True)
    mr = mesh24.get_local_rank(1)
    e_loc = cfg.n_experts // EP_MESH[1]
    local = _moe_view(torch, job["ep_w"], dev,
                      slice(mr * e_loc, (mr + 1) * e_loc))
    ex = job["ep_x"].to(dev)
    ep = {}
    with torch.no_grad():
        for arm, xx, c in (("all_gather", ex, cfg),
                           ("all_to_all", ex,
                            cfg.with_(moe_dispatch="all_to_all")),
                           ("decode", ex[:1, :1], cfg)):
            ep[arm] = timed(f"ep {arm}",
                            lambda: _moe_ep_sharded(local, xx, c, ctx))
        del local
        if rank == 0:
            full = _moe_view(torch, job["ep_w"], dev)
            dense = moe.moe_dense(full, ex, cfg)
            dense1 = moe.moe_dense(full, ex[:1, :1], cfg)
            out["ep"] = {arm: _within(
                torch, got, dense1 if arm == "decode" else dense,
                A2A_TOL if arm == "all_to_all" else EP_TOL)
                for arm, got in ep.items()}
            del full
        out["ep_sums"] = {arm: float(got.double().sum())
                          for arm, got in ep.items()}
    del ep, ex

    # ---- pipeline: two 4-stage pipelines on a (2, 4) data x pipe mesh ----
    pmesh = mesh_lib.make_host_mesh((n // PIPE["stages"], PIPE["stages"]),
                                    ("data", "pipe"), device=job["dev"])
    stage = pmesh.get_local_rank(1)
    w_all = job["pipe_w"].to(dev)
    w_here = w_all[stage:stage + 1].clone().requires_grad_(True)
    w_dt = DTensor.from_local(w_here, pmesh, [Replicate(), Shard(0)],
                              run_check=False)
    micro = job["pipe_micro"].to(dev)

    def stage_fn(w, xx):
        return torch.tanh(xx @ w)

    def pipe_step():
        got = pipeline_parallel.pipeline_apply(stage_fn, w_dt, micro, pmesh,
                                               axis="pipe")
        (got ** 2).sum().backward()
        return got.detach()

    got = timed("pipeline", pipe_step)
    w_ref = w_all.clone().requires_grad_(True)
    want = pipeline_parallel.sequential_reference(stage_fn, w_ref, micro)
    (want ** 2).sum().backward()
    out["pipe"] = {"forward": _within(torch, got, want.detach(), PIPE_TOL),
                   "grad": _within(torch, w_here.grad[0], w_ref.grad[stage],
                                   PIPE_TOL)}
    del w_all, w_here, w_dt, w_ref, micro, got, want

    # ---- sharded training on (2, 4), one checkpoint onto 4 ranks ----
    tcfg = get_config(MESH_TRAIN["arch"], smoke=True)
    opt_cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1,
                                total_steps=MESH_TRAIN["steps"])

    def fresh():
        return model_lib.init_params(
            tcfg, torch.Generator(dev).manual_seed(0), device=dev)

    model = fresh()
    named = model_lib.param_tree(model)
    sharding.place_params(model, sharding.param_shardings(named, tcfg,
                                                          mesh24))
    opt = optim.init_state(sharding.local_tree(model_lib.param_tree(model)))
    step = train_lib.make_train_step(
        tcfg, opt_cfg, ParallelContext(mesh=mesh24, data_axes=("data",)))
    batches = [train_lib.synth_batch(
        torch.Generator(dev).manual_seed(5 + i), tcfg,
        batch=MESH_TRAIN["batch"], seq=MESH_TRAIN["seq"], device=dev)
        for i in range(MESH_TRAIN["steps"])]

    def train_steps():
        nonlocal model, opt
        losses = []
        for batch in batches:
            model, opt, metrics = step(model, opt, batch)
            losses.append(float(metrics["loss"]))
        return losses

    losses = timed("train", train_steps)
    params = model_lib.param_tree(model)
    whole = {k: sharding.gather(p) for k, p in params.items()}
    if rank == 0:
        single = fresh()
        _, g1 = train_lib.value_and_grad(single, batches[0], tcfg)
        sstate = optim.init_state(model_lib.param_tree(single))
        sstep = train_lib.make_train_step(tcfg, opt_cfg)
        slosses = []
        for batch in batches:
            single, sstate, metrics = sstep(single, sstate, batch)
            slosses.append(float(metrics["loss"]))
        worst, exempt = 0.0, 0
        for k, p in model_lib.param_tree(single).items():
            g = g1[k].abs()
            noise = g <= 1e-5 * g.max()
            diff = (whole[k] - p).abs()
            worst = max(worst, float(torch.where(noise, 0.0, diff).max()))
            exempt += int((noise & (diff > MESH_TRAIN_TOL)).sum())
        out["train"] = {"losses": losses, "single_losses": slosses,
                        "loss_err": max(abs(u - v) for u, v in
                                        zip(losses, slosses)),
                        "param_err": worst, "noise_entries_off": exempt}
    ck = Checkpointer(job["ckpt_dir"], device=job["dev"])
    t0 = time.perf_counter()
    ck.save(MESH_TRAIN["steps"], params, extra={"ranks": n})
    save_ms = (time.perf_counter() - t0) * 1e3
    mesh4 = mesh_lib.make_host_mesh((2, n // 4), ("data", "model"),
                                    device=job["dev"])
    shardings4 = sharding.param_shardings(params, tcfg, mesh4)
    if mesh_lib.in_mesh(mesh4):
        template = {k: torch.zeros(p.shape, dtype=p.dtype)
                    for k, p in params.items()}
        t0 = time.perf_counter()
        restored, extra = ck.restore(template, shardings=shardings4)
        restore_ms = (time.perf_counter() - t0) * 1e3
        back = {k: sharding.gather(t) for k, t in restored.items()}
        out["ckpt"] = {
            "equal": all(torch.equal(back[k], whole[k]) for k in whole),
            "extra": extra, "save_ms": save_ms, "restore_ms": restore_ms,
            "moved": sum(t.to_local().numel() for t in restored.values()),
            "leaves": len(restored)}
    dist.barrier()
    out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                       if dev.type == "cuda" else 0.0)
    return out


def knn_mesh_map(knn, x, y, *, params, q, budget):
    """A kNN map task of the mesh phase: the shard's aggregates from its
    draw (the kNN phase's), then ``accurateml_map`` with its bound."""
    agg = knn.build_knn_aggregates(x, y, params, N_CLASSES)
    return knn.accurateml_map(x, y, agg, q, k=K, refine_budget=budget,
                              with_bound=True)


def cf_mesh_map(cf, r, m, *, params, a, am, budget):
    """A CF map task of the mesh phase: the shard's aggregates from its
    draw, then ``accurateml_map`` with its bound (num, den, varsum)."""
    agg = cf.build_cf_aggregates(r, m, params)
    return cf.accurateml_map(r, m, agg, a, am, refine_budget=budget,
                             with_bound=True)


def mesh_phase(torch, knn_data, cf_data, *, dev="cuda", ranks=MESH_RANKS,
               cf_users=CF_MESH_USERS, ep_cfg=None, ep_tokens=EP_TOKENS,
               pipe=PIPE, timeout=MESH_TIMEOUT_S):
    """The mesh path: ``run_ranks`` starts 8 ranks on the one card (gloo:
    NCCL puts no two ranks of a communicator on one device), each on its
    own shard of data the parent made once and shares through host memory.
    Checked against the single-process path on the same draws: the kNN
    labels (``run_accurateml``), the merged distances to the bit and the
    shuffle bytes (``MapReduce(mesh=None)`` over the 8 stacked shards),
    CF's num, den and varsum within 2e-4, the eight kNN and CF kernels
    launched on every rank, the MoE layer against ``moe_dense``, the
    pipeline against ``sequential_reference``, the sharded train step
    against the single-rank one within 1e-5 and the checkpoint's restored
    leaves to the bit.  Returns (summary, launches summed over the
    ranks)."""
    import tempfile

    from repro_torch.apps import cf, knn
    from repro_torch.configs import get_config
    from repro_torch.core import engine, lsh, refine
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import layers, moe

    t_phase = time.perf_counter()
    train_x, train_y, test_x, _ = knn_data
    n_s = train_x.shape[0] // ranks
    gen = torch.Generator(dev).manual_seed(1)      # the kNN phase's draws
    knn_draws = [lsh.init_lsh(gen, train_x.shape[1],
                              lsh.config_for_compression(n_s, RATIO),
                              device=dev) for _ in range(ranks)]
    nr, nm, a, am = (t for t in cf_data[:4])
    nr, nm = nr[:cf_users], nm[:cf_users]
    cf_s = cf_users // ranks
    gen = torch.Generator(dev).manual_seed(11)     # the CF phase's draws
    cf_draws = [lsh.init_lsh(gen, nr.shape[1], lsh.config_for_compression(
        cf_s, CF_RATIO, n_hashes=4, bucket_width=8.0), device=dev)
        for _ in range(ranks)]
    knn_budgets = {eps: refine.eps_to_budget(n_s, eps) for eps in EPS_LEVELS}
    cf_budget = refine.eps_to_budget(cf_s, CF_EPS_LEVELS[-1])

    # the single-process path on the same draws
    want_knn = {}
    for eps, budget in knn_budgets.items():
        labels = knn.run_accurateml(
            train_x, train_y, test_x, k=K, n_classes=N_CLASSES,
            compression_ratio=RATIO, eps_max=eps, lsh_params=knn_draws,
            n_shards=ranks, device=dev)
        stacked, nbytes = [], 0
        for s in range(ranks):
            eng = engine.MapReduce()
            rows = slice(s * n_s, (s + 1) * n_s)
            stacked.append(eng.run(
                partial(knn_mesh_map, knn, params=knn_draws[s], q=test_x,
                        budget=budget),
                engine.CombineSpec("all_gather"), train_x[rows],
                train_y[rows]))
            nbytes += eng.last_shuffle_bytes
        d, lab = knn.merge_topk(torch.cat([o[0] for o in stacked]),
                                torch.cat([o[1] for o in stacked]), K)
        want_knn[eps] = {"labels": labels.cpu(), "d": d.cpu(),
                         "l": lab.cpu(), "shuffle": nbytes}
        del stacked
    want_cf, cf_bytes = None, 0
    for s in range(ranks):
        eng = engine.MapReduce()
        rows = slice(s * cf_s, (s + 1) * cf_s)
        o = eng.run(partial(cf_mesh_map, cf, params=cf_draws[s], a=a, am=am,
                            budget=cf_budget),
                    engine.CombineSpec("psum"), nr[rows], nm[rows])
        want_cf = o if want_cf is None else [u + v for u, v in
                                             zip(want_cf, o)]
        cf_bytes += eng.last_shuffle_bytes
    want_cf = [t.cpu() for t in want_cf]

    # the host copies the ranks share (each copies its own shard over)
    ep_cfg = ep_cfg or get_config(EP_ARCH).with_(
        capacity_factor=MOE_NO_DROP, dtype="float32")
    w = moe.moe_init(layers.Init(torch.Generator(dev).manual_seed(0),
                                 dtype=torch.float32, device=torch.device(
                                     dev)), ep_cfg)
    g = torch.Generator(dev).manual_seed(3)
    scale = 1.0 / math.sqrt(pipe["d"])
    host = lambda t: t.detach().cpu().contiguous()  # noqa: E731
    job = {
        "dev": dev, "ranks": ranks,
        "knn_x": host(train_x), "knn_y": host(train_y), "q": host(test_x),
        "knn_draws": [(host(p.a), host(p.b)) for p in knn_draws],
        "knn_budgets": knn_budgets,
        "cf_r": host(nr), "cf_m": host(nm), "cf_a": host(a),
        "cf_am": host(am), "cf_draws": [(host(p.a), host(p.b))
                                        for p in cf_draws],
        "cf_budget": cf_budget, "ep_cfg": ep_cfg,
        "ep_w": {k: host(v) for k, v in w.named_parameters()},
        "ep_x": host(torch.randn((*ep_tokens, ep_cfg.d_model), generator=g,
                                 device=dev)),
        "pipe_w": host(torch.randn((pipe["stages"], pipe["d"], pipe["d"]),
                                   generator=g, device=dev) * scale),
        "pipe_micro": host(torch.randn((pipe["micro"], pipe["rows"],
                                        pipe["d"]), generator=g,
                                       device=dev)),
    }
    del w
    if dev == "cuda":
        torch.cuda.empty_cache()
    shm = shutil.disk_usage("/dev/shm") if Path("/dev/shm").exists() \
        else None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        job["ckpt_dir"] = tmp
        t0 = time.perf_counter()
        results = run_ranks(mesh_rank, ranks, job, device=dev,
                            timeout=timeout)
        world_s = time.perf_counter() - t0

    # ---- checks ----
    for eps, want in want_knn.items():
        for rk, res in enumerate(results):
            d, lab, vote, bound = res["knn"][eps]["out"]
            if not torch.equal(vote, want["labels"]):
                fail(f"mesh kNN eps={eps}: rank {rk}'s labels differ from "
                     f"run_accurateml's on {int((vote != want['labels']).sum())}"
                     " queries")
            if not (torch.equal(d, want["d"]) and torch.equal(lab, want["l"])):
                fail(f"mesh kNN eps={eps}: rank {rk}'s merged top-k is not "
                     "the bits of MapReduce(mesh=None) over the stacked "
                     "shards")
            if res["knn"][eps]["shuffle"] != want["shuffle"]:
                fail(f"mesh kNN eps={eps}: shuffle bytes "
                     f"{res['knn'][eps]['shuffle']} != {want['shuffle']}")
            if not bool(((bound >= 0) & (bound <= 1)).all()):
                fail(f"mesh kNN eps={eps}: a bound outside [0, 1]")
    cf_err = 0.0
    for rk, res in enumerate(results):
        for name, got, want in zip(("num", "den", "varsum"),
                                   res["cf"]["out"], want_cf):
            ok, err = _within(torch, got, want, CF_TOL)
            cf_err = max(cf_err, err)
            if not ok:
                fail(f"mesh CF: rank {rk}'s {name} off by {err:.3e}")
        if res["cf"]["shuffle"] != cf_bytes:
            fail(f"mesh CF: shuffle bytes {res['cf']['shuffle']} != "
                 f"{cf_bytes}")
        if dev == "cuda":
            missing = [op for op in MESH_KERNELS
                       if res["launches"][op] == 0]
            if missing:
                fail(f"mesh phase: rank {rk} never launched {missing}")
        if res["ep_sums"] != results[0]["ep_sums"]:
            fail(f"mesh EP: rank {rk}'s outputs differ from rank 0's")
        for what, (ok, err) in res["pipe"].items():
            if not ok:
                fail(f"mesh pipeline: rank {rk}'s {what} off by {err:.3e}")
    for arm, (ok, err) in results[0]["ep"].items():
        if not ok:
            fail(f"mesh EP {arm}: off moe_dense by {err:.3e}")
    tr = results[0]["train"]
    if tr["loss_err"] > MESH_TRAIN_TOL or tr["param_err"] > MESH_TRAIN_TOL:
        fail(f"mesh train: losses off by {tr['loss_err']:.3e}, parameters "
             f"by {tr['param_err']:.3e} against the single-rank step")
    for rk in range(ranks // 2):
        ck = results[rk]["ckpt"]
        if not ck["equal"] or ck["extra"] != {"ranks": ranks}:
            fail(f"mesh checkpoint: rank {rk}'s restore onto 4 ranks is not "
                 "the saved bits")
    if any("ckpt" in res for res in results[ranks // 2:]):
        fail("mesh checkpoint: a rank outside the 4-rank mesh restored")
    launches = {op: sum(res["launches"][op] for res in results)
                for op in MESH_KERNELS}
    jobs = {name: [res["ms"][name] for res in results]
            for name in results[0]["ms"]}
    summary = {
        "ranks": ranks, "transport": "gloo on CUDA tensors "
        "(parallel/collectives.py GLOO_CUDA; hops staged through the host)",
        "job_ms_rank0": results[0]["ms"],
        "job_ms_max": {k: max(v) for k, v in jobs.items()},
        "world_s": world_s, "phase_s": time.perf_counter() - t_phase,
        "peak_gib_per_rank": [res["peak_gib"] for res in results],
        "knn_shard": [n_s, train_x.shape[1]], "cf_shard": [cf_s,
                                                          nr.shape[1]],
        "cf_users_cut": int(cf_data[0].shape[0]) - cf_users,
        "knn_budgets": knn_budgets, "cf_budget": cf_budget,
        "shuffle_bytes": {f"knn eps={e}": want_knn[e]["shuffle"]
                          for e in want_knn} | {"cf": cf_bytes},
        "cf_max_abs_err": cf_err, "ep": results[0]["ep"],
        "pipe": results[0]["pipe"], "train": tr,
        "ckpt": {k: results[0]["ckpt"][k] for k in
                 ("save_ms", "restore_ms", "leaves")},
        "launches_per_rank": [res["launches"] for res in results],
        "dev_shm_free_gib": None if shm is None else shm.free / 2**30,
    }
    return summary, launches


def print_mesh(summary, smi):
    ms = summary["job_ms_max"]
    print(f"mesh: {summary['ranks']} ranks on one card through "
          f"{summary['transport']}; world {summary['world_s']:.1f} s, phase "
          f"{summary['phase_s']:.1f} s; slowest rank's job ms "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
          + f"; peak {max(summary['peak_gib_per_rank']):.2f} GiB a rank; "
          f"EP errors {summary['ep']}; pipeline {summary['pipe']}; train "
          f"losses {summary['train']['losses']}; checkpoint save "
          f"{summary['ckpt']['save_ms']:.1f} ms, restore onto 4 ranks "
          f"{summary['ckpt']['restore_ms']:.1f} ms; card: {smi} (8 ranks "
          "time-sliced on one card: no multi-GPU figure)")


# ---------------------------------------------------------------------------
# the examples and the dry run
# ---------------------------------------------------------------------------

# The kernels each of examples/torch_<name>.py launches on its path: all of
# them and no other (PERF.md §6's "launched by" column).
KNN_CF_KERNELS = KNN_KERNELS + CF_KERNELS[:3]
EXAMPLES = {
    "quickstart": KNN_CF_KERNELS,
    "cf_recommend": CF_KERNELS,
    "store_pyramid": ("lsh_hash",),
    "serve_aggregated": KNN_CF_KERNELS,
    "observe_serving": KNN_CF_KERNELS,
    "chaos_serving": KNN_KERNELS,
    "serve_lm_decode": ("distance_topk", "agg_refine_attention"),
    "train_lm": (),
}
EXAMPLES_TRAIN_STEPS = SUP_STEPS        # the supervisor phase's cut
DRYRUN_CELLS = 80                       # 10 archs x 4 shapes x 2 meshes
# the cells built for real: parameters and AdamW state, exact caches and
# aggregated ones (prefill's arguments are train's parameters)
DRYRUN_BUILD_SHAPES = ("train_4k", "decode_32k", "long_500k")
DRYRUN_BUILD_BATCH = 2


class _Beneath:
    """A probe that an example installs (observe_serving's KernelProbe),
    with ``capture`` beneath it: each call passes through both."""

    def __init__(self, outer, capture):
        self.outer, self.capture = outer, capture

    def timed(self, op, fn, args, kwargs):
        return self.outer.timed(
            op, lambda *a, **kw: self.capture.timed(op, fn, a, kw),
            args, kwargs)


def examples_phase(torch, ops, root, probe, *, dev="cuda", argv=None):
    """The eight ``examples/torch_<name>.py``, each by its ``main`` in this
    process on ``dev`` at its defaults (train_lm at EXAMPLES_TRAIN_STEPS,
    observe_serving's exports and train_lm's checkpoints in a temporary
    directory; ``argv``, {name: arguments}, adds to them), its standard
    output kept and printed only if it fails.
    Each must return 0 with its own checks passing, and launch exactly the
    kernels of its EXAMPLES row (the counts set to 0 before each).
    ``probe`` (a CaptureProbe) is installed for each, tagged with its name,
    and stays beneath a probe the example installs itself.
    Returns (summary, launch counts of the phase)."""
    import contextlib
    import io
    import tempfile

    sys.path.insert(0, str(root / "examples"))
    import torch_cf_recommend
    import torch_chaos_serving
    import torch_observe_serving
    import torch_quickstart
    import torch_serve_aggregated
    import torch_serve_lm_decode
    import torch_store_pyramid
    import torch_train_lm

    mains = {"quickstart": torch_quickstart.main,
             "cf_recommend": torch_cf_recommend.main,
             "store_pyramid": torch_store_pyramid.main,
             "serve_aggregated": torch_serve_aggregated.main,
             "observe_serving": torch_observe_serving.main,
             "chaos_serving": torch_chaos_serving.main,
             "serve_lm_decode": torch_serve_lm_decode.main,
             "train_lm": torch_train_lm.main}
    if ops.get_probe() is not None:
        fail("examples phase: a kernel probe is installed")
    set_probe = ops.set_probe

    def beneath(p):
        set_probe(probe if p is None else _Beneath(p, probe))

    t_phase = time.perf_counter()
    total = dict.fromkeys(ops.KERNELS, 0)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        extra = {"observe_serving": ["--out", f"{tmp}/obs"],
                 "train_lm": ["--steps", str(EXAMPLES_TRAIN_STEPS),
                              "--ckpt-dir", f"{tmp}/ckpt"]}
        for name, kernels in EXAMPLES.items():
            text = io.StringIO()
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            probe.tag = f"example {name}"
            set_probe(probe)
            ops.set_probe = beneath
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(text):
                    rc = mains[name](["--device", dev, *extra.get(name, []),
                                      *(argv or {}).get(name, [])])
                torch.cuda.synchronize()
            except BaseException:
                print(text.getvalue())
                raise
            finally:
                ops.set_probe = set_probe
                set_probe(None)
                probe.tag = None
            seconds = time.perf_counter() - t0
            counts = ops.launch_counts()
            launched = {op: n for op, n in counts.items() if n}
            if rc != 0:
                print(text.getvalue())
                fail(f"examples/torch_{name}.py returned {rc}")
            if set(launched) != set(kernels):
                fail(f"examples/torch_{name}.py launched {launched}, "
                     f"expected each of {list(kernels)} and no other")
            for op, n in counts.items():
                total[op] += n
            shapes = sum(key[0] == f"example {name}"
                         for calls in probe.calls.values() for key in calls)
            if kernels and not shapes:
                fail(f"examples/torch_{name}.py: no kernel call captured")
            last = text.getvalue().strip().splitlines()[-1]
            out[name] = {"s": seconds, "launches": launched,
                         "shapes_captured": shapes, "last_line": last[:200]}
            print(f"example torch_{name}: {seconds:.1f} s, launches "
                  f"{launched}, {shapes} shapes captured; {last[:120]}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out, total


def dryrun_phase(torch, *, dev="cuda"):
    """``launch/dryrun.py`` on every cell: ``run_all`` (no files), then one
    device's blocks of each cell allocated on the card, one cell at a
    time: each fits, and nothing is left allocated after it.  Then, for
    each arch at a cut depth (``cut_depth``) and at most
    DRYRUN_BUILD_BATCH sequences, the DRYRUN_BUILD_SHAPES cells' arguments
    built on the card (``build_cell``) and held leaf by leaf, and by
    storage bytes, against ``cell_leaves`` on one device
    (``compare_build``)."""
    from repro_torch.configs import ARCH_NAMES, SHAPES
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    records = dryrun.run_all(save=False)
    sweep_s = time.perf_counter() - t_phase
    if len(records) != DRYRUN_CELLS:
        fail(f"dryrun: {len(records)} cells, expected {DRYRUN_CELLS}")
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    cells = []
    for rec in records:
        got = dryrun.allocate_on_card(rec["arch"], rec["shape"],
                                      rec["mesh"] == "2x16x16", device=dev)
        name = f"{rec['arch']} {rec['shape']} {rec['mesh']}"
        if torch.cuda.memory_allocated(dev) != held:
            fail(f"dryrun {name}: {torch.cuda.memory_allocated(dev) - held} "
                 "bytes still allocated after the cell")
        cells.append((got["bytes"], name, got))
    top_bytes, top_name, top = max(cells, key=lambda c: c[0])
    t_build = time.perf_counter()
    built = {}
    for arch in ARCH_NAMES:
        for shape_name in DRYRUN_BUILD_SHAPES:
            cfg = dryrun.cut_depth(dryrun.cell_config(arch, shape_name))
            shape = SHAPES[shape_name]
            shape = dataclasses.replace(shape, global_batch=min(
                shape.global_batch, DRYRUN_BUILD_BATCH))
            got = dryrun.compare_build(
                cfg, shape, dryrun.build_cell(cfg, shape, device=dev))
            gc.collect()
            torch.cuda.empty_cache()
            name = f"{arch} {shape_name} {cfg.n_layers} layers"
            if got["mismatches"]:
                fail(f"dryrun build {name}: {got['mismatches'][:5]}")
            if got["bytes"] != got["counted"]:
                fail(f"dryrun build {name}: storages {got['bytes']}, "
                     f"counted {got['counted']}")
            built[name] = sum(got["bytes"].values())
    return {"cells": len(cells), "sweep_s": sweep_s,
            "largest": {"cell": top_name, "gib": top_bytes / 2**30, **top},
            "bytes_total": sum(c[0] for c in cells),
            "allocated_total": sum(c[2]["allocated"] for c in cells),
            "built": built, "build_s": time.perf_counter() - t_build,
            "phase_s": time.perf_counter() - t_phase}


def print_dryrun(summary, smi):
    big = summary["largest"]
    print(f"dryrun: {summary['cells']} cells, records in "
          f"{summary['sweep_s']:.1f} s; every cell's blocks allocated on the "
          f"card and freed; largest {big['cell']} {big['gib']:.2f} GiB a "
          f"device; {len(summary['built'])} cut cells built on the card as "
          f"counted, {sum(summary['built'].values()) / 2**30:.1f} GiB in "
          f"{summary['build_s']:.1f} s; phase {summary['phase_s']:.1f} s; "
          f"card: {smi}")


def print_examples(summary, smi):
    print(f"examples phase: {summary['phase_s']:.1f} s ("
          + ", ".join(f"{k} {v['s']:.1f}" for k, v in summary.items()
                      if k != "phase_s") + f" s); card: {smi}")


# ---------------------------------------------------------------------------
# the training path: qwen3-8b's widths, 2 layers, and the blockwise backward
# ---------------------------------------------------------------------------

def blockwise_check(torch, layers, shape=BLOCKWISE_SHAPE, dev="cuda"):
    """``blockwise_sdpa``'s output and hand-written dq, dk, dv against
    autograd through the plain ``_sdpa`` on the same inputs, causal and
    windowed; returns the largest relative errors, and fails past
    BLOCKWISE_TOL."""
    b, s, hkv, g, hd = shape
    gen = torch.Generator(dev).manual_seed(7)
    q, k, v = (torch.randn(sh, generator=gen, device=dev) for sh in
               (shape, (b, s, hkv, hd), (b, s, hkv, hd)))
    ct = torch.randn((b, s, hkv * g, hd), generator=gen, device=dev)
    errs = {}
    for window in (None, BLOCKWISE_WINDOW):
        mask = (layers.sliding_window_mask(s, window, dev) if window
                else layers.causal_mask(s, dev))[None]
        grads = []
        for blockwise in (True, False):
            xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
            if blockwise:
                out = layers.blockwise_sdpa(*xs, scale=hd ** -0.5,
                                            causal=True, window=window)
            else:
                out = layers._sdpa(xs[0].reshape(b, s, hkv * g, hd), xs[1],
                                   xs[2], mask, scale=hd ** -0.5)
            out.backward(ct)
            grads.append([out.detach()] + [x.grad for x in xs])
        name = f"window {window}" if window else "causal"
        errs[name] = {n: float((a - w).abs().max() / w.abs().max())
                      for n, a, w in zip(("out", "dq", "dk", "dv"), *grads)}
        if max(errs[name].values()) > BLOCKWISE_TOL:
            fail(f"blockwise_sdpa {name} at {list(shape)}: relative errors "
                 f"{errs[name]} against autograd through _sdpa, tolerance "
                 f"{BLOCKWISE_TOL}")
    return errs


def train_phase(torch, cfg=None, *, dev="cuda", check_shape=BLOCKWISE_SHAPE):
    """qwen3-8b at its widths, TRAIN_LAYERS deep, bf16 weights and f32
    AdamW moments: ``make_train_step`` on TRAIN_STEPS ``TokenPipeline``
    batches of 1 x TRAIN_SEQ tokens (through its prefetch thread), then
    TRAIN_REPEAT steps on one batch; then the blockwise check."""
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib

    t_phase = time.perf_counter()
    cfg = cfg if cfg is not None else get_config(LM_ARCH).with_(
        n_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = model_lib.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                  device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    opt = optim.init_state(model_lib.param_tree(model))
    step = make_train_step(cfg, optim.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS + TRAIN_REPEAT))
    pipe = TokenPipeline(cfg, global_batch=1, seq_len=TRAIN_SEQ, seed=0,
                         device=dev)
    blockwise_calls = []
    blockwise = layers.blockwise_sdpa

    def counted(*args, **kwargs):
        blockwise_calls.append(args[0].shape)
        return blockwise(*args, **kwargs)

    layers.blockwise_sdpa = counted
    it = pipe.iterate()
    batches = [next(it) for _ in range(TRAIN_STEPS)]
    it.close()
    batches += [pipe.batch_at(TRAIN_STEPS)] * TRAIN_REPEAT
    losses, ms = [], []
    try:
        for batch in batches:
            t0 = time.perf_counter()
            model, opt, metrics = step(model, opt, batch)
            losses.append(float(metrics["loss"]))
            ms.append(_ms_since(torch, t0))
    finally:
        layers.blockwise_sdpa = blockwise
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, opt, batches
    gc.collect()
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: a loss is not finite: {losses}")
    repeated = losses[TRAIN_STEPS:]
    if not repeated[-1] < repeated[0]:
        fail(f"train: the repeated batch's loss did not fall: {repeated}")
    if not blockwise_calls:
        fail("train: attention never took the blockwise path")
    errs = blockwise_check(torch, layers, check_shape, dev)
    p50 = _p50(ms[1:])
    return {"params": n_params, "layers": cfg.n_layers, "seq": TRAIN_SEQ,
            "losses": losses, "step_ms": ms, "step_ms_p50": p50,
            "tokens_per_s": TRAIN_SEQ / (p50 / 1e3), "peak_gib": peak,
            "blockwise_calls": len(blockwise_calls),
            "blockwise_rel_err": errs,
            "phase_s": time.perf_counter() - t_phase}


def print_train(summary, smi):
    print(f"train: {summary['params']} parameters ({summary['layers']} "
          f"layers), 1 x {summary['seq']} tokens a step: step p50 "
          f"{summary['step_ms_p50']:.1f} ms, {summary['tokens_per_s']:.0f} "
          f"tokens/s, peak {summary['peak_gib']:.1f} GiB; losses "
          f"{[round(x, 4) for x in summary['losses']]}; blockwise calls "
          f"{summary['blockwise_calls']}, backward against autograd "
          f"{summary['blockwise_rel_err']}; {summary['phase_s']:.1f} s; "
          f"card: {smi}")


# ---------------------------------------------------------------------------
# the supervisor: checkpoint and restart
# ---------------------------------------------------------------------------

def supervisor_config(get_config):
    """examples/train_lm.py's default model: qwen3-8b's family at d_model
    256, 8 layers, 8 heads over 4 KV heads, d_ff 1024, vocab 4096, f32."""
    return get_config(LM_ARCH, smoke=True).with_(
        d_model=256, n_layers=8, n_heads=8, n_kv_heads=4, d_ff=1024,
        vocab_size=4096, head_dim=32, dtype="float32")


def _supervised(torch, cfg, directory, frac, failures, dev):
    """One supervised run of SUP_STEPS steps: (final state, report, the
    losses by step in execution order, the checkpointer, a step_fn that
    takes the run on)."""
    from repro_torch import optim
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import model as model_lib
    from repro_torch.runtime import FailureInjector, Supervisor

    model = model_lib.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                  device=dev)
    opt_cfg = optim.AdamWConfig(lr=3e-3, warmup_steps=max(SUP_STEPS // 10, 1),
                                total_steps=SUP_STEPS, weight_decay=0.01)
    step = train.make_train_step(cfg, opt_cfg, grad_compress_frac=frac)
    pipe = TokenPipeline(cfg, global_batch=SUP_BATCH, seq_len=SUP_SEQ,
                         device=dev)
    state = {"params": model_lib.param_tree(model),
             "opt": optim.init_state(model_lib.param_tree(model)),
             "loss": torch.zeros((), device=dev)}
    if frac:
        state["ef"] = train.init_error_feedback(model, cfg)
    losses = []

    def step_fn(state, i):
        model_lib.load_param_tree(model, state["params"])
        batch = pipe.batch_at(i)
        if frac:
            _, opt, ef, m = step(model, state["opt"], state["ef"], batch)
            new = {"ef": ef}
        else:
            _, opt, m = step(model, state["opt"], batch)
            new = {}
        losses.append((i, m["loss"]))
        return {"params": model_lib.param_tree(model), "opt": opt,
                "loss": m["loss"], **new}

    ck = Checkpointer(directory, device=dev)
    sup = Supervisor(ck, save_every=SUP_SAVE_EVERY,
                     injector=FailureInjector(dict(failures)))
    state, report = sup.run(state, step_fn, num_steps=SUP_STEPS)
    return state, report, [(i, float(x)) for i, x in losses], ck, step_fn


def supervisor_phase(torch, cfg=None, *, dev="cuda"):
    """examples/train_lm.py's default run on the card: SUP_STEPS steps under
    ``Supervisor`` (save every SUP_SAVE_EVERY, a straggler at
    SUP_STRAGGLER, a node failure at SUP_FAILURE), plain and with
    ``compress_topk`` at SUP_COMPRESS, each against an uninterrupted run.
    Checked to the bit: the re-executed steps' losses equal their first
    execution's and the final state equals the uninterrupted run's; an
    async save restores what it saved; the manifest lists every leaf."""
    import tempfile

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = cfg if cfg is not None else supervisor_config(get_config)
    failures = {SUP_STRAGGLER: "straggler", SUP_FAILURE: "node_failure"}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for frac in (0.0, SUP_COMPRESS):
            name = f"compress {frac}" if frac else "plain"
            state, report, losses, ck, step_fn = _supervised(
                torch, cfg, f"{tmp}/{name}", frac, failures, dev)
            straight, _, straight_losses, _, _ = _supervised(
                torch, cfg, f"{tmp}/{name} straight", frac,
                {SUP_STRAGGLER: "straggler"}, dev)
            if report["restarts"] != 1 or report["final_step"] != SUP_STEPS:
                fail(f"supervisor {name}: report {report}")
            redo = range(SUP_FAILURE // SUP_SAVE_EVERY * SUP_SAVE_EVERY,
                         SUP_FAILURE)
            runs = {i: [x for j, x in losses if j == i] for i in redo}
            if any(len(v) != 2 or v[0] != v[1] for v in runs.values()):
                fail(f"supervisor {name}: re-executed losses {runs} differ "
                     "from their first execution")
            if dict(losses) != dict(straight_losses) or not all(
                    torch.equal(a, b) for a, b in zip(
                        tree_lib.leaves(state), tree_lib.leaves(straight))):
                fail(f"supervisor {name}: the final state differs from the "
                     "uninterrupted run's")
            # an async save of the final state, overwritten at once by one
            # more step, restores what it saved
            want = [t.detach().clone() for t in tree_lib.leaves(state)]
            t0 = time.perf_counter()
            path = ck.save(SUP_STEPS + 1, state, blocking=False)
            async_ms = _ms_since(torch, t0)
            step_fn(state, SUP_STEPS)
            t0 = time.perf_counter()
            ck.wait()
            wait_ms = _ms_since(torch, t0)
            t0 = time.perf_counter()
            restored, _ = ck.restore(state, step=SUP_STEPS + 1)
            restore_ms = _ms_since(torch, t0)
            if not all(torch.equal(a, b) for a, b in
                       zip(tree_lib.leaves(restored), want)):
                fail(f"supervisor {name}: the async save did not restore "
                     "what it saved")
            keys = json.loads((path / "manifest.json").read_text())["keys"]
            if set(keys) != {k for k, _ in tree_lib.flatten_with_path(
                    state)}:
                fail(f"supervisor {name}: the manifest does not list every "
                     "leaf")
            t0 = time.perf_counter()
            ck.save(SUP_STEPS + 2, state, blocking=True)
            out[name] = {
                "report": report, "losses": [x for _, x in losses],
                "redone_steps": list(redo), "leaves": len(keys),
                "checkpoint_bytes": sum(p.stat().st_size
                                        for p in path.iterdir()),
                "save_ms": _ms_since(torch, t0), "async_save_ms": async_ms,
                "async_wait_ms": wait_ms, "restore_ms": restore_ms,
            }
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def print_supervisor(summary, smi):
    for name, s in summary.items():
        if name == "phase_s":
            continue
        print(f"supervisor {name}: {s['report']}; steps "
              f"{s['redone_steps'][0]}-{s['redone_steps'][-1]} re-executed "
              f"to the bit, the final state the uninterrupted run's bits; "
              f"checkpoint {s['checkpoint_bytes']} bytes in {s['leaves']} "
              f"leaves, save {s['save_ms']:.1f} ms (async "
              f"{s['async_save_ms']:.1f} + wait {s['async_wait_ms']:.1f}), "
              f"restore {s['restore_ms']:.1f} ms; card: {smi}")
    print(f"supervisor phase: {summary['phase_s']:.1f} s")


def _shape(key, args, kwargs) -> str:
    shape = " ".join("x".join(str(d) for d in a.shape) for a in args
                     if hasattr(a, "shape"))
    return shape + (f" k={kwargs['k']}" if "k" in kwargs else "") + (
        " ids" if "base" in kwargs else "") + (
        f" ({key[0]})" if key[0] else "")


TOLS = {
    **dict.fromkeys(KNN_KERNELS, f"rtol {RTOL} + atol {ATOL} on distances; "
                    "labels exact except near-ties"),
    "cf_weights": f"rtol {CF_TOL} + atol {CF_TOL} on the weights",
    "cf_refine": f"rtol {CF_TOL} + atol {CF_TOL} on w, num and den, on the "
                 f"first {CF_CHECK_QUERIES} queries of each call",
    "cf_aggregate": "sr, sr2, s and c equal to the plain version's bits",
    "lsh_hash": "hashes off by at most 1 on under 0.1 % of entries; ids "
                "equal on every row whose hashes equal the plain ones, rows "
                "with a flip under 0.1 %",
    **dict.fromkeys(ATTN_KERNELS, f"rtol {ATTN_TOL} + atol {ATTN_TOL} in "
                    "f32 against the plain version on the same (bf16 or "
                    "f32) cache"),
}


def kernel_row(torch, ref, topk_stream, ops, op, calls, counts, jobs, flush,
               checked=None):
    """Check the kernel at every captured shape, ``calls`` and ``checked``
    ({key: (args, kwargs)}, checked and not timed), and time it at the
    shape of ``calls`` with the largest least time (lsh_hash, cf_weights,
    cf_aggregate, distance_topk and the decode-attention kernels, whose
    shapes are different stages or paths: at each shape); the row of the
    ``{"kernels": [...]}`` line."""
    summaries = [check_kernel(torch, ref, topk_stream, ops, op, args, kwargs)
                 for args, kwargs in [*calls.values(),
                                      *(checked or {}).values()]]
    ranked = sorted(calls.items(),
                    key=lambda c: -bound_ms(*work(torch, op, *c[1]))[0])
    timed = []
    every = op in ("lsh_hash", "cf_weights", "cf_aggregate", "distance_topk",
                   *ATTN_KERNELS)
    for key, (args, kwargs) in ranked if every else ranked[:1]:
        b_ms, b_by = bound_ms(*work(torch, op, args, kwargs))
        lib = library_call(torch, op, args, kwargs)
        wrapper = kernel_fns(ops, ref, op, kwargs)[0]
        ms, ms_nh = bench_ms(torch, lambda: wrapper(*args, **kwargs), flush)
        plain, plain_nh = bench_ms(
            torch, plain_call(ops, ref, op, args, kwargs), flush)
        lib_ms, lib_nh = bench_ms(torch, lib, flush) if lib else (None, None)
        timed.append({
            "shape": _shape(key, args, kwargs),
            "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            # the same runs' other half: no head start, the host's gaps in
            "no_head_start": {"ms": ms_nh, "plain_ms": plain_nh,
                              "library_ms": lib_nh},
        })
    top = timed[0]
    row = {
        "name": op, "route": "cuda",
        "source": f"src/repro_torch/csrc/{SOURCES.get(op, op)}.cu",
        "replaces": REPLACES[op], "launches": counts[op],
        "launches_per_job": {job: j["launches"][op] for job, j in jobs.items()
                             if op in j["launches"]},
        "max_abs_err": max(s["max_abs_err"] for s in summaries),
        **{key: top[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "no_head_start")},
        "timed_shape": top["shape"],
        "shapes_checked": len(summaries),
        "example_shapes_checked": len(checked or {}),
        "label_mismatch": sum(s["label_mismatch"] for s in summaries),
        "near_ties": sum(s["near_ties"] for s in summaries),
        "near_tie_examples": [e for s in summaries
                              for e in s["near_tie_examples"]][:3],
        "tol": TOLS[op],
    }
    if len(timed) > 1:
        row["other_shapes"] = timed[1:]
    print(f"{op}: {top['ms']:.3f} ms (plain {top['plain_ms']:.3f}, bound "
          f"{top['bound_ms']:.4f} by {top['bound_by']}, library "
          f"{top['library_ms']}; without the head start "
          f"{top['no_head_start']}) over {len(summaries)} shapes")
    return row


def check_shard_jobs(jobs, op="lsh_hash"):
    """The LSH step (``lsh_hash``) and CF's aggregation (``cf_aggregate``)
    run on their kernels: one launch a shard in every run_accurateml job,
    none in the jobs that build no aggregates (the with_bound batch's are
    built before it is timed)."""
    for name, job in jobs.items():
        want = N_SHARDS if "run_accurateml" in name else 0
        if job["launches"][op] != want:
            fail(f"{name}: {job['launches'][op]} {op} launches, expected "
                 f"{want}")


def check_launched(path, counts, kernels):
    print(f"launches on the {path} path: "
          f"{ {op: counts[op] for op in kernels} }")
    missing = [op for op in kernels if counts[op] == 0]
    if missing:
        fail(f"kernels never launched on the {path} path: {missing}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.apps import cf, knn
    from repro_torch.core import engine, lsh, refine
    from repro_torch.data.synthetic import (
        holdout_split, make_mfeat_like, make_netflix_like,
    )
    from repro_torch.kernels import _build, ops, ref, topk_stream

    # Every f32 product in full f32 (the LM guard's 1e-4 needs it).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    build_kernels(_build)
    probe = CaptureProbe(torch)

    # ---- kNN path ----
    t0 = time.perf_counter()
    train_x, train_y, test_x, test_y = make_data(torch, make_mfeat_like)
    torch.cuda.synchronize()
    print(f"data: {N_TRAIN} x {N_FEATURES} train, {N_QUERY} queries, "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    acc, shuffle_bytes, counts_knn, jobs = knn_path(
        torch, knn, engine, lsh, refine, ops, probe, train_x, train_y, test_x,
        test_y)
    for name, a in acc.items():
        print(f"accuracy {name}: {a:.4f}")
    for eps in EPS_LEVELS:
        loss = knn.accuracy_loss(acc["run_exact"],
                                 acc[f"run_accurateml eps={eps}"])
        print(f"accuracy loss accurateml eps={eps} vs exact: {loss:.4f}")
    print(f"shuffle_bytes: {shuffle_bytes}")
    print(json.dumps({"jobs": jobs, "accuracy": acc,
                      "shuffle_bytes": shuffle_bytes}))
    check_launched("kNN", counts_knn, KNN_KERNELS)
    check_shard_jobs(jobs)
    if acc["run_exact"] < 0.9:
        fail(f"exact accuracy {acc['run_exact']:.4f} < 0.9 on mixture data")

    # ---- CF path ----
    t0 = time.perf_counter()
    cf_data = make_cf_data(torch, make_netflix_like, holdout_split)
    torch.cuda.synchronize()
    print(f"CF data: {CF_USERS} x {CF_ITEMS} neighbourhood, {CF_ACTIVE} "
          f"active users, {(time.perf_counter() - t0) * 1e3:.0f} ms; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    rmse, cf_shuffle_bytes, counts_cf, cf_jobs_out = cf_path(
        torch, cf, engine, lsh, refine, ops, probe, cf_data)
    loss = {name: cf.rmse_loss(rmse["cf.run_exact"], rmse[name])
            for name in rmse if name != "cf.run_exact"}
    for name, r in rmse.items():
        print(f"RMSE {name}: {r:.6f}" + (f", RMSE loss vs exact "
                                         f"{loss[name]:.6f}"
                                         if name in loss else ""))
    print(json.dumps({"cf_jobs": cf_jobs_out, "rmse": rmse,
                      "rmse_loss": loss, "shuffle_bytes": cf_shuffle_bytes}))
    check_launched("CF", counts_cf, CF_KERNELS)
    check_shard_jobs(cf_jobs_out)
    check_shard_jobs(cf_jobs_out, "cf_aggregate")

    # ---- LSH hash phase ----
    n_s = train_x.shape[0] // N_SHARDS
    cf_n_s = cf_data[0].shape[0] // N_SHARDS
    counts_lsh = lsh_phase(torch, ref, lsh, ops, probe, train_x[:n_s],
                           cf_data[0][:cf_n_s], cf_data[1][:cf_n_s])
    check_launched("LSH hash", counts_lsh, LSH_KERNELS)

    # ---- the aggregate store and the servables that read it ----
    store_summary, counts_store = store_phase(
        torch, knn, cf, lsh, refine, ops, probe,
        (train_x, train_y, test_x, test_y), cf_data, rmse["cf.run_exact"])
    print_store(store_summary)
    print(json.dumps({"store": store_summary}))
    check_launched("store", counts_store, STORE_KERNELS)
    torch.cuda.empty_cache()

    # ---- aggregated-KV LM decode ----
    lm_probe = CaptureProbe(torch, clone=True)
    lm_jobs = {}
    lm_summary, counts_lm, lm_model, lm_cfg = lm_phase(torch, ops, lm_probe,
                                                       lm_jobs)
    for op, calls in lm_probe.calls.items():
        probe.calls.setdefault(op, {}).update(calls)

    # ---- MoE and MLA decode: deepseek-v2-236b and moonshot-v1-16b-a3b ----
    moe_summary, counts_moe = decode_phase(torch, ops, lm_probe, lm_jobs,
                                           "moe")
    print(f"moe phase card: {smi}; {moe_summary['phase_s']:.1f} s")
    print(json.dumps({"moe": moe_summary, "card": smi}))
    for op, calls in lm_probe.calls.items():
        probe.calls.setdefault(op, {}).update(calls)

    # ---- the other five families: zamba2, gemma3, qwen2-vl, whisper, xLSTM
    arch_summary, counts_arch = decode_phase(torch, ops, lm_probe, lm_jobs,
                                             "arch")
    print(f"arch phase card: {smi}; {arch_summary['phase_s']:.1f} s")
    print(json.dumps({"arch": arch_summary, "card": smi}))
    for op, calls in lm_probe.calls.items():
        probe.calls.setdefault(op, {}).update(calls)

    # ---- the serving stack: kNN, CF and LM servers ----
    gc.collect()
    torch.cuda.empty_cache()
    serve_summary, counts_serve = serve_phase(
        torch, knn, cf, ops, probe, (train_x, train_y, test_x, test_y),
        cf_data, lm_model, lm_cfg)
    print_serve(serve_summary)
    print(f"serve phase card: {smi}")
    print(json.dumps({"serve": serve_summary}, default=str))
    check_launched("serve", counts_serve, SERVE_KERNELS)
    del lm_model
    gc.collect()
    torch.cuda.empty_cache()
    lm_summary["guard"] = lm_guard_phase(torch)
    print(json.dumps({"lm": lm_summary}))

    # ---- the runtime: the kNN data in failure domains behind a Server ----
    fleet_summary, counts_fleet = fleet_phase(
        torch, ops, probe, (train_x, train_y, test_x, test_y))
    print_fleet(fleet_summary, smi)
    print(json.dumps({"fleet": fleet_summary, "card": smi}))
    check_launched("fleet", counts_fleet, FLEET_KERNELS)

    # ---- the mesh path: 8 ranks on the one card under gloo ----
    gc.collect()
    torch.cuda.empty_cache()
    mesh_summary, counts_mesh = mesh_phase(
        torch, (train_x, train_y, test_x, test_y), cf_data)
    print_mesh(mesh_summary, smi)
    print(json.dumps({"mesh": mesh_summary, "card": smi}, default=str))
    check_launched("mesh", counts_mesh, MESH_KERNELS)

    # ---- the eight examples, in this process ----
    gc.collect()
    torch.cuda.empty_cache()
    examples_probe = CaptureProbe(torch, clone=True)
    examples_summary, counts_examples = examples_phase(torch, ops, root,
                                                       examples_probe)
    print_examples(examples_summary, smi)
    print(json.dumps({"examples": examples_summary, "card": smi}))

    # ---- every kernel against its plain version ----
    counts = {**counts_knn, **{op: counts_cf[op] for op in CF_KERNELS},
              **{op: counts_lm[op] for op in ATTN_KERNELS}}
    counts["distance_topk"] += counts_lm["distance_topk"]
    for op in counts_moe:
        counts[op] += counts_moe[op]
    for op in counts_arch:
        counts[op] += counts_arch[op]
    counts["lsh_hash"] = counts_knn["lsh_hash"] + counts_cf["lsh_hash"]
    for op in STORE_KERNELS:
        counts[op] += counts_store[op]
    for op in SERVE_KERNELS:
        counts[op] += counts_serve[op]
    for op in FLEET_KERNELS:
        counts[op] += counts_fleet[op]
    for op in MESH_KERNELS:
        counts[op] += counts_mesh[op]
    for op in counts_examples:
        counts[op] += counts_examples[op]
    all_jobs = {**jobs, **cf_jobs_out,
                "lsh phase": {"launches": {op: counts_lsh[op]
                                           for op in LSH_KERNELS}},
                "store phase": {"launches": {op: counts_store[op]
                                             for op in STORE_KERNELS}},
                "serve phase": {"launches": {op: counts_serve[op]
                                             for op in SERVE_KERNELS}},
                "fleet phase": {"launches": {op: counts_fleet[op]
                                             for op in FLEET_KERNELS}},
                "mesh phase (8 ranks)": {"launches": counts_mesh},
                **{f"example {k}": {"launches": v["launches"]}
                   for k, v in examples_summary.items() if k != "phase_s"},
                **lm_jobs}
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    rows = [kernel_row(torch, ref, topk_stream, ops, op, probe.calls[op],
                       counts, all_jobs, flush,
                       checked=examples_probe.calls.get(op))
            for op in ops.KERNELS]
    examples_probe.calls.clear()
    del flush, cf_data

    small_check(torch, knn, lsh, refine, make_mfeat_like)
    cf_small_check(torch, cf, lsh, refine, ops, make_netflix_like,
                   holdout_split)
    lm_small_check(torch)

    # ---- the training path and the supervisor (no kernel of the ten) ----
    probe.calls.clear()     # the kernels' captured inputs, checked above
    lm_probe.calls.clear()
    gc.collect()
    torch.cuda.empty_cache()
    train_summary = train_phase(torch)
    print_train(train_summary, smi)
    print(json.dumps({"train": train_summary, "card": smi}))
    torch.cuda.empty_cache()
    sup_summary = supervisor_phase(torch)
    print_supervisor(sup_summary, smi)
    print(json.dumps({"supervisor": sup_summary, "card": smi}))

    # ---- the dry run: every cell's blocks of one device, on the card ----
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_summary = dryrun_phase(torch)
    print_dryrun(dryrun_summary, smi)
    print(json.dumps({"dryrun": dryrun_summary, "card": smi}))

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after start, "
          "the build included")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

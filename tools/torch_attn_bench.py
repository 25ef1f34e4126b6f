#!/usr/bin/env python3
"""Times the port's two decode-attention kernels at the LM path's shapes, on
one NVIDIA GPU, for one source tree of the port.

    python3 tools/torch_attn_bench.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (the
repository's own by default), so that two versions can be compared in one
call on one card: run it on each, in turns (A, B, B, A).  The yardstick is
``chip_smoke.py``'s ``bench_ms`` (median of CUDA-event runs, the L2 cache
flushed before each, read with and without a head start for the card in
alternate runs), the shapes its LM phase's: LM_ARCH's KV heads, query groups
and head width, bf16 caches of LM_S_MAX tokens in LM_S_MAX / LM_COMPRESSION
buckets of 2 LM_COMPRESSION slots.  On random inputs from seed 0, with
``valid_len`` tokens written (LM_PROMPT + LM_NEW_TOKENS at the last decode
step, LM_PROMPT at the last prefill token) and spread over the buckets at
random:

- ``agg_refine_attention`` (bucket-major) at B LM_SLOTS with R from each
  refine_frac of LM_SWEEP above 0, and at B 1 with R of rf 1.0 (a prefill
  token); the R most filled buckets selected;
- ``aggregated_attention`` (flat) at B LM_SLOTS at each refine_frac of
  LM_SWEEP, and at B 1 at rf 1.0; the same buckets refined.

Prints one JSON line: each entry's time with the head start, the same runs'
time without it under ``"... no head start"``, its bound (``chip_smoke.py``'s
``work`` and ``bound_ms``), and the card's name and power limit.  Exits
non-zero when there is no CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_attn_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.aggregated_kv import refine_count

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    out = {"src": str(args.src)}
    cfg = get_config(cs.LM_ARCH)
    hkv, d = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // hkv
    s = cs.LM_S_MAX
    kb = s // cs.LM_COMPRESSION
    cap = 2 * cs.LM_COMPRESSION     # the engine's bucket capacity
    scale = d ** -0.5

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def bench(key, op, fn, call):
        out[key], out[f"{key} no head start"] = cs.bench_ms(torch, fn, flush)
        out[f"{key} bound"] = cs.bound_ms(*cs.work(torch, op, *call))[0]

    def caches(b, vl):
        """Both layouts' caches with vl tokens written, and the buckets'
        counts; bucket_of is random below vl."""
        bucket_of = torch.randint(0, kb, (b, s), generator=gen, device=dev,
                                  dtype=torch.int32)
        written = torch.arange(s, device=dev)[None, :] < vl
        counts = torch.zeros(b, kb, dtype=torch.int32, device=dev)
        counts.scatter_add_(1, bucket_of.long(), written.int().expand(b, s))
        flat = (randn(b, s, hkv, d, dtype=torch.bfloat16),
                randn(b, s, hkv, d, dtype=torch.bfloat16), bucket_of,
                randn(b, kb, hkv, d), randn(b, kb, hkv, d))
        slots = (randn(b, kb, cap, hkv, d, dtype=torch.bfloat16),
                 randn(b, kb, cap, hkv, d, dtype=torch.bfloat16))
        return flat, slots, counts

    vl_decode = cs.LM_PROMPT + cs.LM_NEW_TOKENS
    cases = [(cs.LM_SLOTS, rf, vl_decode) for rf in cs.LM_SWEEP]
    cases.append((1, 1.0, cs.LM_PROMPT))
    for b, rf, vl in cases:
        flat, slots, counts = caches(b, vl)
        r = refine_count(rf, kb)
        top = torch.argsort(counts, dim=1, descending=True, stable=True)
        top_idx = top[:, :max(r, 1)].to(torch.int32).contiguous()
        use = counts.gather(1, top_idx.long()) > 0
        refined = torch.zeros(b, kb, dtype=torch.bool, device=dev)
        if r > 0:
            refined.scatter_(1, top_idx.long(), use)
        valid_len = torch.full((b,), vl, dtype=torch.int32, device=dev)
        q = randn(b, hkv * g, d)
        tag = f"B={b} rf={rf} valid_len={vl}"
        call = ((q, *flat, counts, refined), {"scale": scale,
                                              "valid_len": valid_len})
        bench(f"aggregated_attention {tag}", "aggregated_attention_decode",
              lambda: ops.aggregated_attention_decode(*call[0], **call[1]),
              call)
        if r > 0:
            qg = q.reshape(b, hkv, g, d)
            call_r = ((qg, *slots, counts, top_idx, use), {"scale": scale})
            bench(f"agg_refine_attention {tag} R={r}",
                  "agg_refine_attention",
                  lambda: ops.agg_refine_attention(*call_r[0], **call_r[1]),
                  call_r)
        del flat, slots

    out["device"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's aggregated-KV LM decode, on one
NVIDIA GPU.

    python3 tools/torch_lm_profile.py [--out results/lm.json] [--src DIR]

Builds ``chip_smoke.py``'s LM configuration (qwen3-8b at full width and
depth, bf16, random weights from seed 0; ``DecodeEngine`` with 4 slots,
s_max 1024, compression 16) and, in each cache layout, prefills the four
slots with its prompts (``LM_PROMPT`` tokens each), then at each
refine_frac of the sweep (0, 0.05, 0.25, 1.0):

- two untimed decode steps, then the median of five steps on the host
  clock (``generate_step`` returns after the card is done: ``step_ms``);
- one more step under ``torch.profiler`` with CPU and CUDA activity: the
  device time summed over every kernel and copy (``device_ms``), the idle
  share of the card over that step (1 - device / wall) and the device time
  of the ten costliest operations by name, with the device time of the
  kernels of the path's wrappers (``distance_topk`` and
  ``agg_refine_attention`` or ``aggregated_attention``);

and one batch-1 prefill token (``serve_step`` at refine_frac 1.0, on the
first prompt's caches at the position after it) profiled the same way.
``--src`` is the ``src`` directory whose ``repro_torch`` is imported (the
repository's own by default), so that two trees can be compared in one call.
Prints one JSON line with the results and the card's name and power limit,
and writes it to ``--out`` when given.  Exits non-zero when there is no
CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# The device kernels of each wrapper, by name (each launches one).
KERNEL_NAMES = {
    "distance_topk": ("distance_topk",),
    "agg_refine_attention": ("agg_refine",),
    "aggregated_attention_decode": ("aggregated_attention",),
}


def _device_us(evt) -> float:
    """Device time of one averaged event; 0 for host operations, whose
    kernels are events of their own (counting both would count twice)."""
    from torch.autograd import DeviceType

    if evt.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profiled(torch, fn, ported) -> dict:
    """One run of ``fn`` under the profiler: wall, device and idle share."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = sorted(((e.key, _device_us(e) / 1e3) for e in prof.key_averages()
                  if _device_us(e) > 0), key=lambda kv: -kv[1])
    device_ms = sum(ms for _, ms in ops)
    return {
        "profiled_wall_ms": wall_ms,
        "device_ms": device_ms if device_ms > 0 else "not measured",
        "idle_share": (1.0 - device_ms / wall_ms) if device_ms > 0
        else "not measured",
        "path_kernels_ms": {
            p: sum(ms for name, ms in ops
                   if any(k in name for k in KERNEL_NAMES[p]))
            for p in ported},
        # every device kernel a wrapper's names match: one each
        "path_kernel_names": {
            p: sorted({name[:80] for name, _ in ops
                       if any(k in name for k in KERNEL_NAMES[p])})
            for p in ported},
        "top_ops_device_ms": [[name[:80], ms] for name, ms in ops[:10]],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--src", type=Path, default=ROOT / "src")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_lm_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT), str(ROOT / "tools")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serve.lm.engine import DecodeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    cfg = get_config(cs.LM_ARCH).with_(agg_kv=True,
                                       agg_compression=cs.LM_COMPRESSION)
    model = model_lib.init_params(
        cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
    prompts = cs.lm_prompts(cfg.vocab_size, cs.LM_SLOTS, cs.LM_PROMPT,
                            seed=0)
    result = {"device": smi, "torch": torch.__version__,
              "src": str(args.src), "prompt_tokens": cs.LM_PROMPT,
              "layouts": {}}
    for layout in cs.LM_LAYOUTS:
        lcfg = cfg.with_(agg_layout=layout)
        ported = cs.LM_KERNELS[layout]
        engine = DecodeEngine(model, lcfg, max_slots=cs.LM_SLOTS,
                              s_max=cs.LM_S_MAX,
                              generator=torch.Generator("cuda").manual_seed(7))
        prefixes = [engine.prefill(p) for p in prompts]
        out = {}
        for rf in cs.LM_SWEEP:
            cs.lm_generate(torch, engine, prefixes, rf, 2)   # warm
            times = cs.lm_generate(torch, engine, prefixes, rf, 5)[2]
            out[str(rf)] = {"step_ms": statistics.median(times),
                            "step_ms_runs": times,
                            **profiled(torch,
                                       lambda rf=rf: engine.generate_step(rf),
                                       ported)}
        # one batch-1 prefill token after the first prompt (its caches are
        # updated in place; nothing reads them afterwards)
        caches = prefixes[0].caches
        cfg1 = lcfg.with_(agg_refine_frac=1.0)
        tok = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
        pos = torch.tensor([cs.LM_PROMPT], dtype=torch.int32, device="cuda")
        out["prefill_token"] = profiled(
            torch, lambda: model_lib.serve_step(model, caches, tok, pos, cfg1),
            ported)
        result["layouts"][layout] = out
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

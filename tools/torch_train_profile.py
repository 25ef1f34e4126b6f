#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's train step, on one NVIDIA GPU.

    python3 tools/torch_train_profile.py [--out results/train.json] [--src DIR]

Two configurations of ``chip_smoke.py``:

- ``train``: its train phase's model (qwen3-8b at its published widths,
  ``TRAIN_LAYERS`` deep, bf16 weights, f32 AdamW moments, random weights
  from seed 0) on one ``TokenPipeline`` batch of 1 x ``TRAIN_SEQ`` tokens;
- ``supervisor`` and ``supervisor compress``: its supervisor phase's
  model (``examples/train_lm.py``'s default, f32) on a batch of
  ``SUP_BATCH`` x ``SUP_SEQ`` tokens, without and with ``compress_topk``
  at ``SUP_COMPRESS``.

For each: three untimed steps, then five steps on the host clock, each
split up to a synchronise into its gradient (``launch.train.
value_and_grad``: forward, recomputation and backward), its compression
(where there is one) and its update (``optim.apply_updates``), the
medians printed; then one more step under ``torch.profiler`` with CPU and
CUDA activity: the device time summed over every kernel and copy, the
card's idle share over that step (1 - device / wall), the device time of
the matrix products (kernels named ``gemm``, ``cutlass``, ``xmma`` or
``nvjet``, cuBLAS's) and the ten costliest operations by device time.
``--src`` is the ``src`` directory whose ``repro_torch`` is imported (the
repository's own by default).  Prints one JSON line with the card's name
and power limit, and writes it to ``--out`` when given.  Exits non-zero
when there is no CUDA device.  Imports nothing of JAX.
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
PRODUCT_KERNELS = ("gemm", "cutlass", "xmma", "nvjet")


def _ms(torch, t0) -> float:
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def split_step(torch, run, frac, model, opt, ef, batch):
    """One train step in its three parts; returns (opt, ef, ms by part)."""
    from repro_torch import convert, optim
    from repro_torch.launch import train
    from repro_torch.models import model as model_lib

    cfg, opt_cfg = run["cfg"], run["opt_cfg"]
    ms = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = train.value_and_grad(model, batch, cfg)
    ms["grad"] = _ms(torch, t0)
    if frac:
        t0 = time.perf_counter()
        sent, ef, _ = optim.compress_topk(convert.lm_tree(grads, cfg), ef,
                                          frac=frac)
        grads = convert.lm_named(sent, cfg)
        ms["compress"] = _ms(torch, t0)
    t0 = time.perf_counter()
    params = model_lib.param_tree(model)
    _, opt = optim.apply_updates(params, grads, opt, opt_cfg,
                                 convert.lm_decayed(params, cfg))
    ms["update"] = _ms(torch, t0)
    ms["step"] = sum(ms.values())
    return opt, ef, ms


def profiled(torch, fn) -> dict:
    from torch_lm_profile import _device_us

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        wall_ms = _ms(torch, t0)
    ops = sorted(((e.key, _device_us(e) / 1e3) for e in prof.key_averages()
                  if _device_us(e) > 0), key=lambda kv: -kv[1])
    device_ms = sum(ms for _, ms in ops)
    return {
        "profiled_wall_ms": wall_ms,
        "device_ms": device_ms if device_ms > 0 else "not measured",
        "idle_share": (1.0 - device_ms / wall_ms) if device_ms > 0
        else "not measured",
        "products_device_ms": sum(
            ms for name, ms in ops
            if any(k in name.lower() for k in PRODUCT_KERNELS)),
        "top_ops_device_ms": [[name[:80], ms] for name, ms in ops[:10]],
    }


def profile_run(torch, run, frac) -> dict:
    from repro_torch import optim
    from repro_torch.launch import train
    from repro_torch.models import model as model_lib

    model = model_lib.init_params(
        run["cfg"], torch.Generator("cuda").manual_seed(0), device="cuda")
    opt = optim.init_state(model_lib.param_tree(model))
    ef = train.init_error_feedback(model, run["cfg"]) if frac else None
    batch = run["batch"]
    for _ in range(3):
        opt, ef, _ = split_step(torch, run, frac, model, opt, ef, batch)
    parts: dict[str, list] = {}
    for _ in range(5):
        opt, ef, ms = split_step(torch, run, frac, model, opt, ef, batch)
        for k, v in ms.items():
            parts.setdefault(k, []).append(v)
    state = {"opt": opt, "ef": ef}

    def one_step():
        state["opt"], state["ef"], _ = split_step(
            torch, run, frac, model, state["opt"], state["ef"], batch)

    out = {"params": sum(p.numel() for p in model.parameters()),
           "tokens": batch["tokens"].numel(),
           "ms_p50": {k: statistics.median(v) for k, v in parts.items()},
           "ms_runs": parts, **profiled(torch, one_step)}
    del model, opt, ef, state
    torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--src", type=Path, default=ROOT / "src")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT), str(ROOT / "tools")]
    import chip_smoke as cs
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    train_cfg = get_config(cs.LM_ARCH).with_(n_layers=cs.TRAIN_LAYERS)
    sup_cfg = cs.supervisor_config(get_config)
    runs = {
        "train": ({"cfg": train_cfg, "opt_cfg": optim.AdamWConfig(
            lr=cs.TRAIN_LR, warmup_steps=1),
            "batch": TokenPipeline(train_cfg, global_batch=1,
                                   seq_len=cs.TRAIN_SEQ, device="cuda")
            .batch_at(0)}, 0.0),
    }
    sup = {"cfg": sup_cfg, "opt_cfg": optim.AdamWConfig(
        lr=3e-3, warmup_steps=3, total_steps=cs.SUP_STEPS,
        weight_decay=0.01),
        "batch": TokenPipeline(sup_cfg, global_batch=cs.SUP_BATCH,
                               seq_len=cs.SUP_SEQ, device="cuda")
        .batch_at(0)}
    runs["supervisor"] = (sup, 0.0)
    runs["supervisor compress"] = (sup, cs.SUP_COMPRESS)
    result = {"device": smi, "torch": torch.__version__,
              "src": str(args.src), "runs": {}}
    for name, (run, frac) in runs.items():
        result["runs"][name] = profile_run(torch, run, frac)
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

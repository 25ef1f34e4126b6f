#!/usr/bin/env python3
"""How far two orders of the same float32 sums drift apart in a model, by
depth, on one NVIDIA GPU and the CPU.

    python3 tools/torch_f32_drift.py [--arch xlstm-350m] [--depths 1,2,4,8]
                                     [--tokens 64] [--seed 3]

For each depth it draws the config's weights at its published widths in
float32 (one CPU generator, so the card and the CPU hold the same values)
and runs one prompt of ``--tokens`` tokens through ``forward`` (every
token's projections in one product) and through ``serve_step`` token by
token with exact caches (one product a token), on the card and on the CPU.
It prints the largest absolute difference of the logits between forward
and decode on each device, between the two devices' forwards and between
their decodes, with the logits' largest magnitude: the spread that
``chip_smoke.py``'s f32 guards (1e-4) must stay inside.  TF32 is off.
Exits non-zero when there is no CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def logits_both_ways(torch, model_lib, model, cfg, seq):
    """(forward logits, token-by-token decode logits), [S, vocab] f32 on
    the CPU."""
    fwd = model_lib.forward(model, seq, cfg)[0, :, :cfg.vocab_size]
    caches = model_lib.init_caches(cfg, batch=1, s_max=2 * seq.shape[1],
                                   device=seq.device)
    dec = []
    for t in range(seq.shape[1]):
        pos = torch.tensor([t], dtype=torch.int32, device=seq.device)
        lg, _ = model_lib.serve_step(model, caches, seq[:, t:t + 1], pos, cfg)
        dec.append(lg[0, :cfg.vocab_size])
    return fwd.float().cpu(), torch.stack(dec).float().cpu()


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--depths", default="1,2,4,8")
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_f32_drift: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for depth in (int(d) for d in args.depths.split(",")):
        cfg = get_config(args.arch).with_(n_layers=depth, dtype="float32")
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (1, args.tokens))
        out = {}
        for dev in ("cpu", "cuda"):
            model = model_lib.init_params(
                cfg, torch.Generator().manual_seed(args.seed), device=dev)
            out[dev] = logits_both_ways(torch, model_lib, model, cfg,
                                        torch.as_tensor(tokens, device=dev))
        (fc, dc), (fg, dg) = out["cpu"], out["cuda"]

        def gap(a, b):
            return float((a - b).abs().max())
        print(f"{args.arch} depth {depth}: largest |logit| "
              f"{float(fc.abs().max()):.3f}; forward vs decode: card "
              f"{gap(fg, dg):.3e}, CPU {gap(fc, dc):.3e}; card vs CPU: "
              f"forward {gap(fg, fc):.3e}, decode {gap(dg, dc):.3e}",
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

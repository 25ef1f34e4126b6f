"""End-to-end training on the PyTorch port: data pipeline -> train
step -> checkpointing -> fault-tolerant supervisor loop, as
``examples/train_lm.py`` does with the JAX package.

Default trains a ~25M-parameter qwen3-family model for 150 steps on the
card (``--device cpu`` on the CPU; scale --d-model/--layers/--steps up).
Demonstrates:

  * deterministic resumable TokenPipeline,
  * AdamW + cosine schedule (+ optional top-k gradient compression),
  * atomic checkpoints every --save-every steps + restart recovery,
  * optional injected node failure to exercise the recovery path.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 150
"""
import argparse
import os
import sys
import tempfile
import time

import torch

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve
from repro_torch.launch.train import init_error_feedback, make_train_step
from repro_torch.models.model import init_params, load_param_tree, param_tree
from repro_torch.runtime import FailureInjector, Supervisor


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--grad-compress", type=float, default=0.0,
                    help="top-k fraction (0 = off)")
    ap.add_argument("--inject-failure-step", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    cfg = get_config(args.arch, smoke=True).with_(
        d_model=args.d_model, n_layers=args.layers, n_heads=args.heads,
        n_kv_heads=args.kv_heads, d_ff=args.d_ff, vocab_size=args.vocab,
        head_dim=args.d_model // args.heads, dtype="float32",
    )
    from repro_torch.configs.base import param_count
    print(f"arch={cfg.name} params~{param_count(cfg)/1e6:.1f}M "
          f"tokens/step={args.batch * args.seq}")

    opt_cfg = optim.AdamWConfig(
        lr=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps, weight_decay=0.01,
    )
    model = init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    opt_state = optim.init_state(param_tree(model))
    pipe = TokenPipeline(cfg, global_batch=args.batch, seq_len=args.seq,
                         device=dev)

    use_gc = args.grad_compress > 0.0
    # updates the model's parameters and the moments in place
    step = make_train_step(
        cfg, opt_cfg, grad_compress_frac=args.grad_compress
    )

    state = {
        "params": param_tree(model),
        "opt": opt_state,
        "loss": torch.zeros((), device=dev),
    }
    if use_gc:
        state["ef"] = init_error_feedback(model, cfg)

    losses = []
    t_start = time.perf_counter()

    def step_fn(state, i):
        # a restored state's tensors become the model's
        load_param_tree(model, state["params"])
        batch = pipe.batch_at(i)
        if use_gc:
            _, o, ef, metrics = step(model, state["opt"], state["ef"], batch)
            new = {"params": param_tree(model), "opt": o, "ef": ef,
                   "loss": metrics["loss"]}
        else:
            _, o, metrics = step(model, state["opt"], batch)
            new = {"params": param_tree(model), "opt": o,
                   "loss": metrics["loss"]}
        loss = float(metrics["loss"])
        losses.append(loss)
        if i % 10 == 0:
            dt = time.perf_counter() - t_start
            print(f"step {i:4d}  loss {loss:.4f}  ({dt:.1f}s)")
        return new

    ck = Checkpointer(args.ckpt_dir, device=dev)
    inject = (
        FailureInjector({args.inject_failure_step: "node_failure"})
        if args.inject_failure_step >= 0 else FailureInjector()
    )
    sup = Supervisor(ck, save_every=args.save_every, injector=inject)
    state, report = sup.run(
        state, step_fn, num_steps=args.steps, state_template=state,
    )
    print(f"done: first-10-avg loss {sum(losses[:10])/10:.4f} -> "
          f"last-10-avg {sum(losses[-10:])/10:.4f}; report={report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

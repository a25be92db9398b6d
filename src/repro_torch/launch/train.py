"""Training entry point: data pipeline -> train_step -> checkpoints, resumable.

Counterpart of ``repro/launch/train.py``, on one card (or the CPU).  The
same flags, plus ``--device`` (the card by default; it raises without
one, as ``launch/serve.py`` does).  ``--reduced`` is off by default, as in
the reference: the full config of ``--arch`` is built unless it is given.
Fault tolerance as there: atomic checkpoints every ``--ckpt-every`` steps
in the reference's layout, ``--resume auto`` picks up the latest complete
one, and the stateless data pipeline replays the exact stream from any
step.  ``main`` returns the losses of the steps it ran.

  python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
      --steps 6 --global-batch 4 --seq-len 4096 --grad-accum 2
  python -m repro_torch.launch.train --arch granite-20b --reduced \
      --steps 50 --global-batch 8 --seq-len 128 --device cpu

The model trains in its config's compute dtype (bf16 for the full
configs) with f32 master parameters and AdamW moments (8-bit with
``--opt8``).  Every family trains on the card: attention's gradient is
K3-bwd, the SSD scan's K4-bwd (ssm and hybrid models).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.convert import (
    train_state_from_numpy, train_state_to_numpy,
)
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import step as step_mod


def build(args):
    mod = configs.get(args.arch)
    cfg = mod.reduced() if args.reduced else mod.make_config()
    if args.d_model:
        cfg = dataclasses.replace(
            cfg, d_model=args.d_model, d_ff=args.d_ff or 4 * args.d_model,
            n_layers=args.n_layers or cfg.n_layers)
    oc = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                             total_steps=args.steps,
                             quantize_state=args.opt8)
    return cfg, oc


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--opt8", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", choices=["auto", "none"], default="auto")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    # overrides for the ~100M example preset
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None, on_step=None):
    """Train; returns the per-step losses.  ``on_step(step, state,
    metrics, seconds)``, when given, is called after each step with the
    step's host wall time (ended by a synchronize on the card)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    cfg, oc = build(args)
    print(f"arch={cfg.name} params~{cfg.param_count():,} "
          f"steps={args.steps} gb={args.global_batch} seq={args.seq_len}")

    pipe = TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, seed=args.seed))

    state = step_mod.init_train_state(
        cfg, oc, torch.Generator(device=dev).manual_seed(args.seed))
    start = 0
    if args.ckpt_dir and args.resume == "auto":
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            start, tree = ckpt.restore(args.ckpt_dir,
                                       train_state_to_numpy(cfg, state))
            state = train_state_from_numpy(cfg, tree, dev)
            print(f"resumed from step {start}")

    ts = step_mod.make_train_step(cfg, oc, grad_accum=args.grad_accum)
    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        batch = pipe.device_batch_at(step, dev)
        t_step = time.perf_counter()
        state, m = ts(state, batch)
        loss = float(m["loss"])
        losses.append(loss)
        if on_step is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            on_step(step, state, m, time.perf_counter() - t_step)
        if (step + 1) % args.log_every == 0:
            dt = (time.time() - t0) / max(step + 1 - start, 1)
            print(f"step {step + 1:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(m['grad_norm']):.2f} "
                  f"lr {float(m['lr']):.2e} {dt:.2f}s/step", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1,
                      train_state_to_numpy(cfg, state))
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, train_state_to_numpy(cfg, state))
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()

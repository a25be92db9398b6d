"""Serving entry point: prefill + batched decode with sampling.

Counterpart of ``repro/launch/serve.py``.  A batch of random prompts goes
through ``engine.prefill`` and is decoded step-locked with temperature
sampling; the first token is the argmax of the prefill logits.  The weights
are a random init from ``--seed`` (no pretrained weights are in the repo).

  python -m repro_torch.launch.serve --device cpu          # reduced config
  python -m repro_torch.launch.serve --no-reduced --batch 4 \
      --prompt-len 2048 --gen 32                           # full width, card

The reference's ``--reduced`` is ``store_true`` with ``default=True``, so
its CLI can never reach the full config; here it is a
``BooleanOptionalAction``: reduced by default, ``--no-reduced`` for the
full config.  ``--device`` defaults to the card and raises without one.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serving import engine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, params, prompts: torch.Tensor, gen: int,
          temperature: float = 0.8, seed: int = 0) -> dict:
    """Prefill ``prompts (B, S)`` and decode ``gen`` tokens per sequence.

    Returns ``tokens (B, gen)`` and the host wall times of prefill and of
    the ``gen - 1`` decode steps (each ended by a synchronize on the card).
    """
    dev = prompts.device
    b, s = prompts.shape
    cap = s + gen + 8
    _sync(dev)
    t0 = time.perf_counter()
    state, logits = engine.prefill(cfg, params, {"tokens": prompts}, cap)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    sampler = torch.Generator(device=dev).manual_seed(seed + 1)
    tok = torch.argmax(logits, dim=-1)[:, None]
    outs = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        state, logits = engine.decode_step(cfg, params, state, tok)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=sampler)
        outs.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return {"tokens": torch.cat(outs, dim=1), "prefill_s": prefill_s,
            "decode_s": decode_s, "decode_steps": gen - 1}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    dev = resolve_device(args.device)
    mod = configs.get(args.arch)
    cfg = mod.reduced() if args.reduced else mod.make_config()
    init_gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = tfm.init_params(cfg, init_gen)

    rng = np.random.RandomState(args.seed)
    prompts = torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        device=dev)
    out = serve(cfg, params, prompts, args.gen, args.temperature, args.seed)
    print(f"prefill {args.batch}x{args.prompt_len} in {out['prefill_s']:.2f}s")
    n_tok = out["decode_steps"] * args.batch
    rate = n_tok / out["decode_s"] if out["decode_s"] > 0 else float("nan")
    print(f"decoded {args.gen} tokens x {args.batch} seqs in "
          f"{out['decode_s']:.2f}s ({rate:.1f} tok/s)")
    print("sample:", out["tokens"][0, :16].tolist())
    out["cfg"] = cfg
    return out


if __name__ == "__main__":
    main()

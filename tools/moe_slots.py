"""Where granite-moe's MoE dispatch puts its empty capacity slots, on the
card, and what they cost the token gather.

    python3 tools/moe_slots.py [--seed N] [--out FILE]

Builds the benchmark's ``granite-moe-1b-a400m.train`` state from the seed
(``bench/``: weights, batch and the train step as a run makes them), runs
one training step with ``models.mlp._dispatch`` wrapped, and reads from
each dispatch call: the share of its e x cap slots left empty and the most
slots any one token holds, as the dispatch gives them and as the token-0
sentinels would (every empty slot on token 0, the weights unchanged).  At
the first call's indices it then times, by CUDA events (median of REPS),
the token gather with the scatter-add back to the tokens and their
backward (the gather's is PyTorch's sort-based accumulating index_put_),
with the spread indices and with the token-0 ones.  It prints the card's
name and power limit and one JSON object; ``--out`` appends it to a file.
It exits 1 where no card is visible.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CELL = "granite-moe-1b-a400m.train"
REPS = 10


def _largest_run(tok: torch.Tensor, t: int) -> int:
    return int(torch.bincount(tok.reshape(-1), minlength=t).max())


def _time_ms(fn) -> float:
    times = []
    for _ in range(REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def gather_times(tok, w, t: int, d: int, seed: int) -> dict:
    """ms of the gather + scatter-add forward alone and with their
    backward, at ``tok`` (e, cap), weights ``w``."""
    g = torch.Generator(device=tok.device).manual_seed(seed)
    x = torch.randn(t, d, generator=g, device=tok.device).to(torch.bfloat16)
    gout = torch.randn(t, d, generator=g, device=tok.device
                       ).to(torch.bfloat16)
    wv = w.detach()[..., None].to(torch.bfloat16)
    x.requires_grad_(True)

    def forward():
        xe = x[tok]
        return torch.zeros(t, d, dtype=xe.dtype, device=x.device).index_add_(
            0, tok.reshape(-1), (xe * wv).reshape(-1, d))

    def both():
        forward().backward(gout)

    for _ in range(3):
        both()
    return {"forward_ms": _time_ms(forward),
            "forward_backward_ms": _time_ms(both)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from bench.harness.cell import load

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    cell = load(CELL)
    run = cell.runner().Run(cell, args.seed, dev)
    run.state, run.train_step = run.program.train_state(
        run.leaf, run.paths, run.mix)
    from repro_torch.models import mlp

    spread = mlp._dispatch
    calls = []

    def recording(eid, wgt, k, e, cap):
        tok, w = spread(eid, wgt, k, e, cap)
        t = eid.shape[-1] // k
        kept = w != 0                  # kept slots' softmax weights are > 0
        calls.append({"t": t, "slots": kept.numel(),
                      "empty": int((~kept).sum()),
                      "largest_run": _largest_run(tok, t),
                      "largest_run_token0": _largest_run(
                          torch.where(kept, tok, 0), t),
                      "tok": tok if not calls else None,
                      "w": w.detach() if not calls else None})
        return tok, w

    mlp._dispatch = recording
    try:
        run.step()
        torch.cuda.synchronize(dev)
    finally:
        mlp._dispatch = spread
    first = calls[0]
    tok, w, t = first["tok"], first["w"], first["t"]
    d = run.program.cfg.d_model
    token0 = torch.where(w != 0, tok, 0)
    shares = [c["empty"] / c["slots"] for c in calls]
    runs0 = [c["largest_run_token0"] for c in calls]
    out = {"card": card, "seed": args.seed, "calls": len(calls),
           "t": t, "e_cap": first["slots"],
           "empty_share": {"min": min(shares), "max": max(shares),
                           "median": statistics.median(shares)},
           "largest_run": max(c["largest_run"] for c in calls),
           "largest_run_token0": {"min": min(runs0), "max": max(runs0)},
           "gather_spread": gather_times(tok, w, t, d, args.seed),
           "gather_token0": gather_times(token0, w, t, d, args.seed)}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

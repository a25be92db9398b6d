"""Time K3-bwd (``repro_torch.kernels.flash_attention_bwd``) of a given
source tree on the card, so that two trees can be compared on one card.

    python3 tools/k3b_times.py [--src DIR] [--out FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's); its kernels build into ``build/`` beside it.
At each shape of ``SHAPES`` (the four phase 14 (a) shapes the dh 32 / 64
backward of the CUDA-core design already took) it makes bf16 q, k, v and
dO from a fixed seed, runs the tree's K3 forward for o and the lse, and
times the tree's K3-bwd by CUDA events (the median of ``BATCHES`` means
over ``REPS`` calls each); it holds dq, dk and dv to the tree's plain twin
in f32 by relative L2.  To compare two trees, run them in one call in
the order A, B, B, A and read the rows beside each other.

It prints the card's name and power limit, one JSON line per shape and,
last, a JSON object with every row; ``--out`` appends that object to a
file.  It exits 1 where no card is visible.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

#: name -> (b, hq, hkv, sq, skv, dh, causal, window, q_offset).
SHAPES = {
    "granite-moe training": (2, 16, 8, 4096, 4096, 64, True, None, 0),
    "hymba swa": (4, 25, 5, 2048, 2048, 64, True, 1024, 0),
    "whisper encoder": (4, 16, 16, 1500, 1500, 64, False, None, 0),
    "dh 32, q_offset": (2, 8, 2, 1000, 1100, 32, True, None, 100),
}
REPS = 10
BATCHES = 5


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def mean_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: K3-bwd cannot be timed", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import flash_attention, flash_attention_bwd, ref

    where = Path(repro_torch.__file__).resolve()
    if src not in where.parents:
        raise RuntimeError(f"imported {where}, not the tree under {src}")
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for name, (b, hq, hkv, sq, skv, dh, causal, window, q_offset) in \
            SHAPES.items():
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(torch.bfloat16) for shape in (
                           (b, hq, sq, dh), (b, hkv, skv, dh),
                           (b, hkv, skv, dh), (b, hq, sq, dh)))
        mask = (causal, window, q_offset)
        o, lse = flash_attention.flash_attention_cuda(q, k, v, *mask,
                                                      return_lse=True)

        def run():
            return flash_attention_bwd.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, *mask)

        got = run()
        want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                       o.float(), lse, do.float(), *mask)
        rels = {f"d{n}": rel_l2(g, w) for n, g, w in zip("qkv", got, want)}
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        times = sorted(mean_ms(run, REPS) for _ in range(BATCHES))
        row = dict(shape=name, dims=[b, hq, hkv, sq, skv, dh], causal=causal,
                   window=window, q_offset=q_offset, dtype="bfloat16",
                   ms=times[BATCHES // 2], ms_batches=times, rel_l2=rels)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, do, o, lse, got, want
        torch.cuda.empty_cache()
    out = dict(src=str(src), package=str(where.parent), card=card,
               torch=torch.__version__, cuda=torch.version.cuda, rows=rows)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

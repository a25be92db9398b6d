"""Time K4-bwd (``repro_torch.kernels.ssd_bwd``) of a given source tree on
the card, so that two trees can be compared on one card.

    python3 tools/k4b_times.py [--src DIR] [--out FILE] [--plain]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's); its kernels build into ``build/`` beside it.
At each shape of ``SHAPES`` (hymba-1.5b's and mamba2-2.7b's training
microbatch, chunk 128, mild decay) it makes x, a, B, C, dy and dfinal
from a fixed seed, runs the tree's K4 forward for cum and the states, and
times the tree's K4-bwd by CUDA events (the median of ``BATCHES`` means
over ``REPS`` calls each); it holds dx, da, dB and dC to the tree's plain
twin (``ref.ssd_scan_bwd``) by relative L2 and max |err| / max(1, max
|plain|), and reads the bytes a call allocates beyond its inputs (the
outputs and the scratch) from the allocator's peak.  ``--plain`` also
times the plain twin.  To compare two trees, run them in one call in the
order A, B, B, A and read the rows beside each other.

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

#: name -> (b, s, nh, dh, g, ds, chunk).
SHAPES = {
    "hymba-1.5b training": (2, 4096, 50, 64, 1, 16, 128),
    "mamba2-2.7b training": (2, 4096, 80, 64, 1, 128, 128),
}
A_SCALE = 0.3
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: K4-bwd cannot be timed", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import ref, ssd, ssd_bwd

    where = Path(repro_torch.__file__).resolve()
    if src not in where.parents:
        raise RuntimeError(f"imported {where}, not the tree under {src}")
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    rows = []
    for name, (b, s, nh, dh, g, ds, chunk) in SHAPES.items():
        def draw(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        x, a = draw(b, s, nh, dh) * 0.3, -draw(b, s, nh).abs() * A_SCALE
        bm, cm = draw(b, s, g, ds) * 0.3, draw(b, s, g, ds) * 0.3
        dy, dfin = draw(b, s, nh, dh), draw(b, nh, dh, ds)
        _, s_fin, cum, s_prev = ssd.ssd_passes_cuda(x, a, bm, cm, chunk)
        inp = (x, a, bm, cm, cum, s_prev, s_fin, dy, dfin)

        def run():
            return ssd_bwd.ssd_scan_bwd_cuda(*inp, chunk)

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = run()
        torch.cuda.synchronize()
        call_bytes = torch.cuda.max_memory_allocated() - base
        out_bytes = sum(t.numel() * t.element_size() for t in got)
        want = ref.ssd_scan_bwd(*inp, chunk)
        errs = {}
        for n, g_, w in zip(("dx", "da", "dB", "dC"), got, want):
            errs[n] = dict(
                rel_l2=float((g_ - w).norm() / w.norm()),
                max_abs_err=float((g_ - w).abs().max())
                / max(1.0, float(w.abs().max())))
        del got, want
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        times = sorted(mean_ms(run, REPS) for _ in range(BATCHES))
        row = dict(shape=name, dims=[b, s, nh, dh, g, ds], chunk=chunk,
                   a_scale=A_SCALE, ms=times[BATCHES // 2], ms_batches=times,
                   call_bytes=call_bytes, scratch_bytes=call_bytes - out_bytes,
                   errors=errs)
        if args.plain:
            row["plain_ms"] = mean_ms(lambda: ref.ssd_scan_bwd(*inp, chunk),
                                      2)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, a, bm, cm, dy, dfin, s_fin, cum, s_prev, inp
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

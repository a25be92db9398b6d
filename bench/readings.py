#!/usr/bin/env python3
"""The readings a cell's limits are set from: the numbers ``correct``
compares, for the program on many seeds (the lower readings), for the
control and for planted faults (the upper ones), in one process.

    python3 bench/readings.py --workload hymba-1.5b.train \
        --seeds 1-12 --control 1-3 --faults half_batch --fault-seeds 1-3

For each seed the program runs as a benchmark run does up to the
comparison (a training cell: set-up and its checked steps; a prefill
cell: set-up and a ``--seconds`` window, long enough to finish the first
cycle, whose sample is compared), and the reference follows in f32.  The
control is the reference put in the program's place in fp8
(``reference.precision("fp8")``), compared with the f32 reference.  A
fault is planted in the program (``harness/program.py``), or for
``half_batch`` in training in the reference put in its place.  Each
reading is one JSON line; the last line is the summary: per number, the
largest sound reading and the smallest control and fault readings.  The
benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def seeds(text: str) -> list[int]:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def numbers_of(run, ref, read=None) -> dict:
    """The compared numbers, and where the worst of each was."""
    got = run.numbers(ref, read)
    return {k: v for k, v in got.items() if not k.startswith("_")} | {
        "where": got["_where"]}


def readings(cell, seed_list, control, faults, fault_seeds, seconds,
             device, emit) -> dict:
    """Emit every reading -> the summary."""
    sound, ctrl, fault = [], [], {f: [] for f in faults}
    runner = cell.runner()
    for seed in seed_list:
        t0 = time.perf_counter()
        run = runner.Run(cell, seed, device)
        run.setup()
        if cell.kind == "prefill":
            run.window(seconds)
        run.release()
        ref = run.reference()
        got = numbers_of(run, ref)
        sound.append(got)
        emit({"seed": seed, "what": "program", "numbers": got,
              "seconds": time.perf_counter() - t0})
        if seed in control:
            got = numbers_of(run, ref, run.reference("fp8"))
            ctrl.append(got)
            emit({"seed": seed, "what": "control fp8", "numbers": got})
        for f in faults if seed in fault_seeds else ():
            if cell.kind == "train" and f == "half_batch":
                got = numbers_of(run, ref, run.reference(fault=f))
            else:
                bad = runner.Run(cell, seed, device, fault=f)
                bad.setup()
                if cell.kind == "prefill":
                    bad.window(seconds)
                    bad.release()
                    got = numbers_of(run, ref, bad.kept)
                else:
                    bad.release()
                    got = numbers_of(run, ref, bad.read)
                del bad
            fault[f].append(got)
            emit({"seed": seed, "what": f"fault {f}", "numbers": got})
        del run, ref
    summary = {"lower": {}, "control": {}, "faults": {}}
    for k in [k for k in sound[0] if k != "where"] if sound else ():
        summary["lower"][k] = max(r[k] for r in sound)
        if ctrl:
            summary["control"][k] = min(r[k] for r in ctrl)
        for f, rs in fault.items():
            if rs:
                summary["faults"].setdefault(f, {})[k] = min(r[k] for r in rs)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control", type=seeds, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    import torch

    from bench.harness.cell import load
    from bench.run import finite

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    def emit(d):
        print(json.dumps(finite(d), default=str), flush=True)

    summary = readings(load(args.workload), args.seeds, set(args.control),
                       [f for f in args.faults.split(",") if f],
                       set(args.fault_seeds), args.seconds,
                       torch.device("cuda", 0), emit)
    emit({"workload": args.workload, "summary": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its result.

    python3 bench/run.py --workload hymba-1.5b.train --seed 7 \
        --seconds 40 --trace 0

The cell, its configuration, traffic mix and metrics come from
``BENCHMARK.json`` and the files under ``bench/`` (``harness/cell.py``).
A run loads the program, builds its state from the seed and warms every
shape the cell's traffic uses (``setup_s``), measures for ``--seconds``, with
``--trace 1`` profiles a short sub-window after it and reads the cell's
per-layer metrics from that trace, then frees the program's state and
holds what the timed path produced to the plain reference
(``bench/reference``).  The last lines on standard error are the numbers
compared, each beside its limit; the last line on standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.

It exits with 2 and prints no result without a card (or with fewer than
the cell asks for), and with 3 if a JAX module (or the JAX package) was
loaded in the process.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def finite(x):
    """Non-finite numbers as null, so the line stays JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             fault: str | None = None, log=print) -> dict:
    """One run of ``cell`` on ``device`` -> the result (``numbers`` and
    ``reference_s`` beside the contract's keys)."""
    import torch

    from bench.harness import compare, peaks
    from bench.harness.cell import metric_reader
    from bench.harness.trace import traced

    t0 = time.perf_counter()
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    run = cell.runner().Run(cell, seed, device, fault)
    load_s = time.perf_counter() - t0
    setup_s = load_s + run.setup()
    log("setup " + json.dumps(dict(load_s=load_s,
                                   **getattr(run, "phases", {}))))
    window = run.window(seconds)
    metrics = dict(window["metrics"], setup_s=setup_s)
    log("end_to_end " + json.dumps(metrics))
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    result = {"correct": False, "attempted": window["attempted"],
              "failed": window["failed"],
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in metrics.items() if k in units}}
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": 1}
    if trace:
        held: dict = {}
        with traced(device, held) as sub_window:
            traced_units = run.trace_window(sub_window)
        tr = held["trace"]
        ctx = SimpleNamespace(
            kind=cell.kind, config=cell.config, mix=cell.mix, trace=tr,
            traced=traced_units,
            traced_items=(cell.mix["trace_steps"] if cell.kind == "train"
                          else len(traced_units)),
            window_units=run.window_units, window_s=run.window_s,
            peaks=peaks.for_device(kind) if on_card else None)
        result["metrics"] = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": tr.idle_gaps(10)}
        log("kernels " + json.dumps(tr.top_ops(40)))
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if on_card else 0)
    run.release()
    t0 = time.perf_counter()
    numbers = run.numbers(run.reference())
    reference_s = time.perf_counter() - t0
    ok, checks = compare.verdict(numbers, cell.spec.get("limits", {}))
    result["correct"] = ok and window["failed"] == 0
    breakdown = result.pop("breakdown", None)
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    result["numbers"] = numbers
    result["reference_s"] = reference_s
    return result


def main(argv=None) -> int:
    args = parse(argv)
    # Python's bytecode of every module the run imports, torch's too, in the
    # checkout: without it each run compiles the modules that the program
    # first loads in set-up from source again (5 s, and as variable as the
    # host's speed, on the card's machine).
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    import torch

    from bench.harness.cell import benchmark, load

    bench = benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    cell = load(args.workload, bench)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"card: {power_limit()}", flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    print(f"reference {result.pop('reference_s'):.1f} s; numbers "
          + json.dumps(finite(result.pop("numbers")), default=str),
          flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

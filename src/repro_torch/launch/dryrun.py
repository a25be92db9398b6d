"""Dry run: trace every (arch x shape x mesh) cell on the meta device.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell with XLA on 512 forced host devices and records XLA's memory and
cost analyses.  The port has no XLA; what stands in for each analysis:

* "compiles": the cell's step (``launch.steps.build_cell``) traces end to
  end on ``meta`` under ``torch.utils.flop_counter.FlopCounterMode``.
  Meta tensors take the kernels' plain versions (``kernels/ops.py``), and
  nothing is allocated, so the full configs trace on a host.  A shape
  error is a failure, as a compile error is in the reference.
* ``flops_per_device``: the counted global FLOPs divided by the mesh's
  chips, an even split (``flops_split: "even"``).  FlopCounterMode counts
  the matrix products (mm, bmm, addmm, baddbmm, convolution, attention),
  not elementwise work (norms, AdamW's update, which traces too, each leaf
  in one chunk: ``_whole_leaves``).  It sees every layer, so the reference's
  ``block_cost`` (XLA visits a scanned layer once) has no counterpart
  here.
* ``memory.argument_bytes``: exact, the per-device bytes of every input
  leaf under its fitted spec, which is what XLA's
  ``argument_size_in_bytes`` reports.
* ``temp_bytes``, ``output_bytes``, ``collectives``: ``null``, with
  ``"analysis": "meta"``.  There is no SPMD partitioner, so no collective
  schedule exists to read, and none is estimated.

The trace does not depend on the mesh, so a grid traces each (arch,
shape) once and records it at each mesh.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import time
import traceback

from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.distributed import partition
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.training import optimizer as opt_mod


def argument_bytes(args_sds, in_specs, axis_sizes: dict) -> int:
    """Per-device bytes of every input leaf under its spec."""
    total = 0
    for sd, spec in zip(partition.tree_leaves(args_sds),
                        partition.tree_leaves(in_specs,
                                              is_leaf=partition.is_spec),
                        strict=True):
        total += partition.spec_bytes(sd, spec, axis_sizes)
    return total


@contextlib.contextmanager
def _whole_leaves():
    """AdamW updates each leaf in one chunk.  ``optimizer.UPDATE_CHUNK``
    bounds a real update's temporaries; on meta nothing is allocated, and
    chunks of it would make kimi-k2's trillion parameters tens of
    thousands of traced ops."""
    before = opt_mod.UPDATE_CHUNK
    opt_mod.UPDATE_CHUNK = 1 << 62
    try:
        yield
    finally:
        opt_mod.UPDATE_CHUNK = before


def trace_cell(cell: dict) -> dict:
    """Run the cell's step on meta under FlopCounterMode -> ``{"flops",
    "trace_s"}``."""
    t0 = time.perf_counter()
    args = cell["trace_args"]()
    with FlopCounterMode(display=False) as counter, _whole_leaves():
        cell["fn"](*args)
    return {"flops": int(counter.get_total_flops()),
            "trace_s": time.perf_counter() - t0}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             variant: str = "", *, reduced: bool = False,
             trace: dict | None = None) -> dict:
    """One cell's record; ``trace`` reuses another mesh's trace of the same
    (arch, shape, variant)."""
    t0 = time.perf_counter()
    devices = ["meta"] * (512 if multi_pod else 256)
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod, devices=devices)
    cell = steps_mod.build_cell(arch, shape_name, multi_pod, variant,
                                reduced=reduced)
    arg_bytes = argument_bytes(cell["args_sds"], cell["in_specs"],
                               mesh.shape)
    if trace is None:
        trace = trace_cell(cell)
    cfg = cell["cfg"]
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "16x16",
        "variant": variant or "baseline",
        "reduced": reduced,
        "kind": cell["kind"],
        "analysis": "meta",
        "trace_s": trace["trace_s"],
        "build_s": time.perf_counter() - t0,
        "chips": mesh.size,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "flops_global": trace["flops"],
        "flops_per_device": trace["flops"] / mesh.size,
        "flops_split": "even",
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": None,
            "temp_bytes": None,
        },
        "collectives": None,
    }


def run_grid(cells, meshes, variant: str = "", reduced: bool = False,
             out: str | None = None, log=print) -> tuple[list, list]:
    """Every (arch, shape) of ``cells`` at every mesh of ``meshes``
    (``multi_pod`` flags) -> (records, failures), one JSON per record
    under ``out``."""
    records, failures = [], []
    for arch, shape in cells:
        trace = None
        for mp in meshes:
            tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
            if variant:
                tag += "_" + re.sub(r"[^A-Za-z0-9]+", "-", variant)
            try:
                rec = run_cell(arch, shape, mp, variant, reduced=reduced,
                               trace=trace)
                trace = {"flops": rec["flops_global"],
                         "trace_s": rec["trace_s"]}
                records.append(rec)
                if out:
                    with open(os.path.join(out, tag + ".json"), "w") as f:
                        json.dump(rec, f, indent=1)
                log(f"OK   {tag:60s} trace={rec['trace_s']:7.2f}s "
                    f"flops/dev={rec['flops_per_device']:.3e} "
                    f"args/dev={rec['memory']['argument_bytes'] / 2**30:.3f}"
                    f"GiB")
            except Exception as e:  # noqa: BLE001 — report, continue grid
                failures.append((tag, repr(e)))
                log(f"FAIL {tag}: {e}")
                traceback.print_exc()
    return records, failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--variant", default="")
    ap.add_argument("--all", action="store_true",
                    help="run the full assigned grid")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's tiny same-family config")
    ap.add_argument("--out", default="runs/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s) for a in configs.ARCHS for s in configs.shapes_for(a)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    records, failures = run_grid(cells, meshes, args.variant, args.reduced,
                                 args.out, lambda *a: print(*a, flush=True))
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         + ", ".join(t for t, _ in failures))
    print("all cells traced")
    return records


if __name__ == "__main__":
    main()

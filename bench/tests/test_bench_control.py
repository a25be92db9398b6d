"""``correct`` fails the control and every planted fault.

The control is the reference put in the program's place, one precision
below the configurations' bf16: fp8 (e4m3) products.  On the CPU, at the
tiny size, the control must read at least three times what the program
reads on one of a cell's numbers; on the card (``-m cuda``), at each
cell's own size on three seeds, it must fail the cell's limits.  The
faults are planted underneath a whole run (``harness/program.py``), which
skips only the look for a card, and each must turn ``correct`` false."""
from __future__ import annotations

import pytest
import torch

from bench.harness import compare
from bench.harness.cell import benchmark, load
from bench.tests.tiny import tiny

CPU = torch.device("cpu")
CELLS = [w["name"] for w in benchmark()["workloads"]]
#: The cells a CPU run drives: the benchmark's, and a prefill one per
#: configuration (``tiny.py``).
RUN_CELLS = CELLS + [f"{c['name']}.prefill" for c in benchmark()["configs"]]
FAULTS = {"train": ("unchanged", "half_batch"),
          "prefill": ("unchanged", "half_batch", "altered")}


def _numbers(cell, seed, device, seconds=1.0):
    """(program, control) numbers of one seed, against the f32 reference."""
    run = cell.runner().Run(cell, seed, device)
    run.setup()
    if cell.kind == "prefill":
        run.window(seconds)
    run.release()
    ref = run.reference()
    return run.numbers(ref), run.numbers(ref, run.reference("fp8"))


@pytest.mark.parametrize("name", RUN_CELLS)
def test_the_control_reads_far_above_the_program(name):
    for seed in (3, 2 ** 35 + 17):
        sound, control = _numbers(tiny(name), seed, CPU)
        ratios = {k: control[k] / max(sound[k], 1e-12) for k in sound
                  if not k.startswith("_")}
        assert max(ratios.values()) >= 3.0, ratios


@pytest.mark.parametrize("name", RUN_CELLS)
def test_every_planted_fault_turns_correct_false(name):
    from bench.run import run_cell

    cell = tiny(name)
    for fault in FAULTS[cell.kind]:
        result = run_cell(cell, 2 ** 33 + 7, 0.5, False, CPU, fault=fault,
                          log=lambda s: None)
        assert result["correct"] is False, (fault, result["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits_at_the_cells_size(name, card):
    cell = load(name)
    for seed in (101, 202, 303):
        _, control = _numbers(cell, seed, card, seconds=6.0)
        ok, checks = compare.verdict(control, cell.spec["limits"])
        assert not ok, checks

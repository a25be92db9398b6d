"""The traced window split by the program's ``train.*`` spans
(``harness/spans.py``) and the three metrics that read it."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from bench.harness import spans
from bench.harness.cell import benchmark
from bench.harness.trace import Trace, traced
from bench.metrics import backward_ms, forward_ms, optimizer_ms
from bench.tests.tiny import tiny

#: (phase, start, end) on thread 1, in us, inside the window 0..1000.
SPANS = [("train.forward", 100, 300), ("train.backward", 300, 600),
         ("train.optimizer", 600, 800)]
#: (correlation, launch thread, launch time, kernel start, kernel end).
LAUNCHES = [(5, 1, 50, 60, 90),        # before the spans: other
            (1, 1, 150, 200, 250),     # forward
            (2, 2, 400, 420, 550),     # backward, from the device thread
            (3, 2, 450, 540, 580),     # backward, overlapping the one before
            (4, 1, 650, 700, 760),     # optimizer
            (6, 1, 850, 870, 900)]     # after the spans: other
#: (busy, idle) us of each phase: a gap goes to the operation that ends it,
#: an overlap to the operation that started first, the window's end to
#: other.
EXPECTED = {"other": (60, 60 + 110 + 100), "train.forward": (50, 110),
            "train.backward": (130 + 30, 170), "train.optimizer": (60, 120)}


def _events(with_spans: bool = True) -> list[dict]:
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 0, "dur": 1000, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 140,
           "dur": 20, "tid": 1}]
    if with_spans:
        ev += [{"ph": "X", "cat": "user_annotation", "name": name, "ts": t0,
                "dur": t1 - t0, "tid": 1} for name, t0, t1 in SPANS]
    for corr, tid, ts, t0, t1 in LAUNCHES:
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": ts, "dur": 2,
                   "tid": tid, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": t0,
                   "dur": t1 - t0, "tid": 7, "args": {"correlation": corr}})
    return ev


def _ctx(trace, steps=2):
    return SimpleNamespace(trace=trace, traced_items=steps)


def test_each_phase_takes_its_operations_and_the_gaps_they_end():
    tr = Trace(_events())
    split = spans.phases(tr)
    assert set(split) == set(EXPECTED)
    for name, (busy, idle) in EXPECTED.items():
        assert split[name][0] == pytest.approx(busy * 1e-6), name
        assert split[name][1] == pytest.approx(idle * 1e-6), name
    assert sum(b + i for b, i in split.values()) == \
        pytest.approx(tr.window_s)
    assert sum(b for b, _ in split.values()) == pytest.approx(tr.busy_s)


@pytest.mark.parametrize("reader,phase", [
    (forward_ms, "train.forward"), (backward_ms, "train.backward"),
    (optimizer_ms, "train.optimizer")])
@pytest.mark.parametrize("steps", [1, 2, 4])
def test_the_metrics_read_busy_ms_per_traced_step(reader, phase, steps):
    busy, _ = EXPECTED[phase]
    assert reader.read(_ctx(Trace(_events()), steps)) == \
        pytest.approx(busy * 1e-3 / steps)


@pytest.mark.parametrize("reader", [forward_ms, backward_ms, optimizer_ms])
def test_no_spans_no_reading(reader):
    tr = Trace(_events(with_spans=False))
    assert spans.phases(tr) is None
    assert reader.read(_ctx(tr)) is None
    assert reader.read(_ctx(None)) is None


def test_per_layer_sources_are_the_contracts():
    for m in benchmark()["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "host_clock"), m["name"]


def test_a_traced_cpu_run_holds_the_trainer_spans():
    """The window's steps each mark ``grad_accum`` forward and backward
    spans and one optimizer span, in that order, as the profiler writes
    them into the trace the metrics read."""
    cell = tiny("granite-moe-1b-a400m.train")
    run = cell.runner().Run(cell, 2 ** 33 + 5, torch.device("cpu"))
    run.setup()
    held: dict = {}
    with traced(torch.device("cpu"), held) as window:
        run.trace_window(window)
    tr = held["trace"]
    seen = sorted((t0, name) for ops in tr._host.values()
                  for t0, t1, name in ops
                  if name in spans.PHASES and tr.w0 <= t0 and t1 <= tr.w1)
    ga = cell.mix["grad_accum"]
    step = ["train.forward", "train.backward"] * ga + ["train.optimizer"]
    assert [name for _, name in seen] == step * cell.mix["trace_steps"]
    run.release()

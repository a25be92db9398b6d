"""The program's ``ssm.mixer`` and ``optimizer.moments`` spans in a traced
run, and the busy time of one span name (``harness/named_spans.py``) that
``ssm_mixer_ms`` and ``moment_code_ms`` read."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from bench.harness import named_spans, spans
from bench.harness.trace import Trace, traced
from bench.metrics import moment_code_ms, ssm_mixer_ms
from bench.tests.tiny import tiny

#: (name, thread, start, end) in us, inside the window 0..1000: a mixer in
#: the forward on thread 1, its recompute on autograd's thread 2 inside the
#: backward, the moments' code inside the optimizer.
SPANS = [("train.forward", 1, 100, 300), ("ssm.mixer", 1, 120, 280),
         ("train.backward", 1, 300, 600), ("ssm.mixer", 2, 320, 400),
         ("train.optimizer", 1, 600, 800),
         ("optimizer.moments", 1, 610, 640),
         ("optimizer.moments", 1, 700, 720)]
#: (correlation, launch thread, launch time, kernel start, kernel end).
LAUNCHES = [(1, 1, 110, 115, 125),     # forward, before the mixer
            (2, 1, 150, 160, 200),     # the mixer
            (3, 1, 250, 190, 240),     # the mixer, overlapping the one before
            (4, 2, 350, 360, 420),     # the recompute's mixer
            (5, 2, 450, 410, 500),     # the backward, overlapping it
            (6, 1, 615, 650, 660),     # the code (runs after its span)
            (7, 1, 660, 665, 690),     # the update between the two spans
            (8, 1, 705, 700, 730)]     # the code again
#: Busy us of each name: an overlap goes to the operation that started
#: first.
EXPECTED = {"ssm.mixer": 40 + 40 + 60, "optimizer.moments": 10 + 30}


def _events(names=("ssm.mixer", "optimizer.moments")) -> list[dict]:
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 0, "dur": 1000, "tid": 1}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": name, "ts": t0,
            "dur": t1 - t0, "tid": tid} for name, tid, t0, t1 in SPANS
           if name.startswith("train.") or name in names]
    for corr, tid, ts, t0, t1 in LAUNCHES:
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": ts, "dur": 2,
                   "tid": tid, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": t0,
                   "dur": t1 - t0, "tid": 7, "args": {"correlation": corr}})
    return ev


def _ctx(trace, steps=2):
    return SimpleNamespace(trace=trace, traced_items=steps)


@pytest.mark.parametrize("reader,name", [(ssm_mixer_ms, "ssm.mixer"),
                                         (moment_code_ms,
                                          "optimizer.moments")])
@pytest.mark.parametrize("steps", [1, 2])
def test_the_readers_read_busy_ms_per_traced_step(reader, name, steps):
    tr = Trace(_events())
    assert named_spans.busy_s(tr, name) == pytest.approx(
        EXPECTED[name] * 1e-6)
    assert reader.read(_ctx(tr, steps)) == pytest.approx(
        EXPECTED[name] * 1e-3 / steps)


@pytest.mark.parametrize("reader", [ssm_mixer_ms, moment_code_ms])
def test_no_span_no_reading(reader):
    tr = Trace(_events(names=()))
    assert spans.phases(tr) is not None
    assert reader.read(_ctx(tr)) is None
    assert reader.read(_ctx(None)) is None


def test_overlapping_spans_of_one_name_count_once():
    ev = _events()
    ev.append({"ph": "X", "cat": "user_annotation", "name": "ssm.mixer",
               "ts": 130, "dur": 30, "tid": 3})
    assert named_spans.busy_s(Trace(ev), "ssm.mixer") == pytest.approx(
        EXPECTED["ssm.mixer"] * 1e-6)


def _traced_spans(name: str):
    """A tiny cell's traced window -> (the cell, ``(start, end, name)`` of
    every ``train.*``, ``ssm.mixer`` and ``optimizer.moments`` span in it,
    in order)."""
    cell = tiny(name)
    run = cell.runner().Run(cell, 2 ** 33 + 5, torch.device("cpu"))
    run.setup()
    held: dict = {}
    with traced(torch.device("cpu"), held) as window:
        run.trace_window(window)
    run.release()
    tr = held["trace"]
    keep = set(spans.PHASES) | {"ssm.mixer", "optimizer.moments"}
    return cell, sorted((t0, t1, n) for ops in tr._host.values()
                        for t0, t1, n in ops
                        if n in keep and tr.w0 <= t0 and t1 <= tr.w1)


def _inside(seen, name):
    """The ``train.*`` phase around each span ``name``, in order."""
    phases = [s for s in seen if s[2] in spans.PHASES]
    return [[p[2] for p in phases if p[0] <= t0 and t1 <= p[1]]
            for t0, t1, n in seen if n == name]


def test_a_traced_mamba2_step_marks_each_mixer_twice_and_the_code():
    cell, seen = _traced_spans("mamba2-2.7b.train")
    layers, ga = cell.config["n_layers"], cell.mix["grad_accum"]
    step = (["train.forward"] * layers + ["train.backward"] * layers) * ga
    assert _inside(seen, "ssm.mixer") == [[p] for p in
                                          step * cell.mix["trace_steps"]]
    code = _inside(seen, "optimizer.moments")
    # one leaf is one chunk at this size: its decode, then its encode
    leaves = len(cell.reference().param_specs(cell.config))
    assert code == [["train.optimizer"]] * (2 * leaves
                                            * cell.mix["trace_steps"])


def test_f32_moments_mark_no_code():
    cell, seen = _traced_spans("hymba-1.5b.train")
    assert cell.mix["optimizer"]["moments"] == "f32"
    assert _inside(seen, "optimizer.moments") == []
    layers, ga = cell.config["n_layers"], cell.mix["grad_accum"]
    assert len(_inside(seen, "ssm.mixer")) == \
        2 * layers * ga * cell.mix["trace_steps"]

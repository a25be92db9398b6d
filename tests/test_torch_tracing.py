"""``repro_torch.tracing``: spans follow the profiler, and the kernels'
launch counters live there."""
from __future__ import annotations

import pytest
import torch

from repro_torch import tracing
from repro_torch.kernels import build, ops


def test_a_span_is_a_user_annotation_under_the_profiler():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("phase.a"):
            torch.ones(3).sum()
    assert [e.name for e in prof.events() if e.name == "phase.a"] == \
        ["phase.a"]


@pytest.mark.parametrize("profile", [torch.profiler.profile,
                                     torch.autograd.profiler.profile])
def test_a_span_follows_the_profiler_at_call_time(profile):
    """One shared no-op while nothing records, ``record_function`` while
    the profiler does."""
    assert tracing.span("a") is tracing.span("b") is tracing._NO_SPAN
    with tracing.span("a"):
        pass
    with profile():
        assert isinstance(tracing.span("a"),
                          torch.autograd.profiler.record_function)
    assert tracing.span("a") is tracing._NO_SPAN


def test_a_span_holds_the_operations_run_inside_it():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer"):
            torch.zeros(2).add_(1)
            with tracing.span("phase.a"):
                torch.ones(4).mul(3).sum()
    events = prof.events()
    outer, = [e for e in events if e.name == "outer"]
    span, = [e for e in events if e.name == "phase.a"]
    inside = [e.name for e in events
              if span.time_range.start <= e.time_range.start
              and e.time_range.end <= span.time_range.end
              and e is not span]
    assert outer.time_range.start <= span.time_range.start
    assert span.time_range.end <= outer.time_range.end
    assert "aten::mul" in inside and "aten::sum" in inside
    assert "aten::add_" not in inside


def test_the_launch_counters_are_tracings():
    assert not hasattr(build, "LaunchCounter")
    assert all(isinstance(c, tracing.LaunchCounter) for c in ops.COUNTERS)
    c = tracing.LaunchCounter("k")
    c.launched((1, 2))
    c.shapes = set()
    c.launched((3, 4))
    assert c.count == 2 and c.shapes == {(3, 4)}

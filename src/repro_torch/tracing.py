"""The program's spans, and the kernels' launch counters.

Spans: ``span(name)`` marks a phase of the program.  While
``torch.profiler`` records, it is ``torch.profiler.record_function(name)``,
so the span lands in the profiler's trace as a ``user_annotation`` event,
on the same clock as the device operations the phase launches.  While
nothing records, it is one shared no-op context: no allocation and no
call into PyTorch.  No flag or setting turns spans on: they follow the
profiler.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` in the profiler's trace while the
    profiler records, and does nothing otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


class LaunchCounter:
    """Launches of one hand kernel: the wrapper calls :meth:`launched` once
    per launch, with the shape arguments of the library's plan query
    (``csrc/budget.cuh``).  ``shapes`` is ``None`` unless a caller (the
    static analyzer's ``kernel_budget.record_launches``) sets it to a set,
    which then collects the shape of every launch."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.shapes: set | None = None

    def launched(self, shape: tuple) -> None:
        self.count += 1
        if self.shapes is not None:
            self.shapes.add(shape)

"""The traced window split by the program's own phases: the ``train.*``
spans that ``repro_torch/training/step.py`` marks while the profiler
records (``repro_torch.tracing.span``).

Each device operation of the window goes to the span whose interval holds
the operation's launch (its ``cuda_runtime`` / ``cuda_driver`` event, by
correlation), on whatever thread the span is: remat's recompute and the
rest of the backward launch from autograd's device thread while the main
thread waits inside ``train.backward``.  A phase's busy time is its
operations' share of the union of all operations' intervals (where two
overlap, the one that started first keeps the overlap); its idle time is
each gap before one of its operations, the rule ``Trace.idle_gaps``
names gaps by.  What no span takes, the gap at the window's end included,
is ``other``, so the phases and ``other`` add up to the window.

The metrics read a phase's busy time only: it holds from run to run.  The
idle time is mostly the profiler's own host cost, which an untraced step
does not pay (on an H100, hymba-1.5b's traced step takes 2.1-3.5 s, its
untraced one ~1.8 s, and its phases' busy times add up to ~1.7 s).

The spans and launches are read from the ``Trace``'s host events
(``_host``, ``_launch``), which ``trace.py`` keeps for ``idle_gaps``.
"""
from __future__ import annotations

import bisect

PHASES = ("train.forward", "train.backward", "train.optimizer")
OTHER = "other"


def phases(trace) -> dict | None:
    """``{phase: (busy_s, idle_s)}`` for each of ``PHASES`` that the trace
    holds a span of, and ``other``; ``None`` when it holds none, or no
    device operation."""
    spans = sorted((t0, t1, name) for ops in trace._host.values()
                   for t0, t1, name in ops if name in PHASES)
    if not spans or not trace.ops:
        return None
    starts = [s[0] for s in spans]

    def phase(corr) -> str:
        _, ts = trace._launch.get(corr, (None, None))
        if ts is None:
            return OTHER
        i = bisect.bisect_right(starts, ts) - 1
        return spans[i][2] if i >= 0 and spans[i][1] >= ts else OTHER

    out = {name: [0.0, 0.0] for name in {s[2] for s in spans} | {OTHER}}
    end = trace.w0
    for t0, t1, _, corr in trace.ops:
        part = out[phase(corr)]
        if t0 > end:
            part[1] += t0 - end
        if t1 > end:
            part[0] += t1 - max(t0, end)
            end = t1
    out[OTHER][1] += trace.w1 - end
    return {k: (busy * 1e-6, idle * 1e-6) for k, (busy, idle) in out.items()}


def phase_ms(ctx, name: str):
    """Phase ``name``'s busy milliseconds per traced step, or ``None`` where
    the trace holds no such span."""
    if ctx.trace is None or not ctx.traced_items:
        return None
    split = phases(ctx.trace)
    if split is None or name not in split:
        return None
    return 1e3 * split[name][0] / ctx.traced_items

"""The traced window's busy time inside the program's spans of one name,
such as ``ssm.mixer`` or ``optimizer.moments`` (``repro_torch.tracing.span``),
which may sit inside the ``train.*`` phases of ``spans.py``.

A device operation belongs to the name when its launch (its
``cuda_runtime`` / ``cuda_driver`` event, by correlation) falls inside a
span of that name, on whatever thread the span is: under remat a layer's
recompute marks its spans on autograd's device thread.  Its busy time is
its share of the union of all operations' intervals, where two overlap
the one that started first keeping the overlap: the rules of
``spans.phases``, whose sweep this repeats for one name.
"""
from __future__ import annotations

import bisect


def _intervals(trace, name: str) -> list:
    """The spans named ``name``, on every thread, merged where they
    overlap: sorted, disjoint ``[t0, t1]`` in us."""
    out: list = []
    for t0, t1 in sorted((t0, t1) for ops in trace._host.values()
                         for t0, t1, n in ops if n == name):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def busy_s(trace, name: str) -> float | None:
    """Busy seconds of the operations launched inside spans ``name``, or
    ``None`` where the trace holds no such span or no device operation."""
    spans = _intervals(trace, name)
    if not spans or not trace.ops:
        return None
    starts = [s[0] for s in spans]

    def inside(corr) -> bool:
        _, ts = trace._launch.get(corr, (None, None))
        if ts is None:
            return False
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and spans[i][1] >= ts

    busy, end = 0.0, trace.w0
    for t0, t1, _, corr in trace.ops:
        if t1 > end:
            if inside(corr):
                busy += t1 - max(t0, end)
            end = t1
    return busy * 1e-6


def span_ms(ctx, name: str):
    """Busy milliseconds per traced step or request inside spans ``name``,
    or ``None`` where the trace holds none."""
    if ctx.trace is None or not ctx.traced_items:
        return None
    s = busy_s(ctx.trace, name)
    return None if s is None else 1e3 * s / ctx.traced_items

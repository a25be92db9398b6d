"""A traced sub-window: ``torch.profiler`` over a few steps or requests,
reduced to what the per-layer metrics read.

The profiler's Chrome trace is written to the run's temporary directory,
parsed and deleted.  What is kept:

* the device operations (kernels, copies, sets) that ran inside the window
  (the ``bench.window`` annotation, which ends after a synchronize), each
  with its name and interval;
* ``busy_s``: the union of those intervals, so overlapping operations on
  two streams count once; ``window_s``: the annotation's length;
* the idle gaps between them, each named by what the host was doing: the
  innermost host operation around the launch of the device operation that
  ends the gap (``host`` where none encloses it; ``window end`` for the
  gap after the last one).

A kernel's short name (``base_name``) drops ``void``, namespaces, template
arguments and parameters, so a metric matches the kernels of a family by
prefix whatever instance ran.
"""
from __future__ import annotations

import bisect
import contextlib
import gzip
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def base_name(name: str) -> str:
    """``void ns::(anonymous namespace)::k<64, true>(P)`` -> ``k``."""
    name = short_name(name, len(name))
    return name.split("<", 1)[0].rsplit("::", 1)[-1].strip()


def short_name(name: str, limit: int = 120) -> str:
    """The name without ``void``, namespaces and the parameter list."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    return (name.split("(", 1)[0] or name)[:limit]


class Trace:
    """The device operations and host operations of a traced window."""

    def __init__(self, events: list[dict]):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no bench.window annotation")
        self.w0 = float(win[0]["ts"])
        self.w1 = self.w0 + float(win[0]["dur"])
        self.ops = []           # (t0, t1, name, correlation) in us
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                t0 = float(e["ts"])
                t1 = t0 + float(e.get("dur", 0))
                if t1 > self.w0 and t0 < self.w1:
                    self.ops.append((max(t0, self.w0), min(t1, self.w1),
                                     e["name"],
                                     e.get("args", {}).get("correlation")))
        self.ops.sort()
        self._launch = {}       # correlation -> (tid, ts) of the launch
        self._host = defaultdict(list)    # tid -> [(ts, te, name)]
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self._launch[corr] = (e.get("tid"), float(e["ts"]))
            elif cat in ("cpu_op", "user_annotation") and \
                    e.get("name") != WINDOW:
                t0 = float(e["ts"])
                self._host[e.get("tid")].append(
                    (t0, t0 + float(e.get("dur", 0)), e["name"]))
        for ops in self._host.values():
            ops.sort()
        self._starts = {tid: [o[0] for o in ops]
                        for tid, ops in self._host.items()}

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, self.w0
        for t0, t1, _, _ in self.ops:
            if t1 <= end:
                continue
            busy += t1 - max(t0, end)
            end = t1
        return busy * 1e-6

    def device_seconds(self, match) -> float:
        """Seconds of the device operations whose name ``match`` accepts
        (a callable of the full name), summed."""
        return sum(t1 - t0 for t0, t1, name, _ in self.ops
                   if match(name)) * 1e-6

    def prefix_seconds(self, prefixes: tuple) -> float:
        """Seconds of the kernels whose ``base_name`` starts with one of
        ``prefixes``."""
        return self.device_seconds(
            lambda n: base_name(n).startswith(prefixes))

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for t0, t1, name, _ in self.ops:
            by[short_name(name)] += (t1 - t0) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]

    def _host_op(self, corr) -> str:
        tid, ts = self._launch.get(corr, (None, None))
        ops = self._host.get(tid)
        if not ops:
            return "host"
        i = bisect.bisect_right(self._starts[tid], ts) - 1
        for j in range(i, max(-1, i - 256), -1):
            if ops[j][1] >= ts:
                return ops[j][2]
        return "host"

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time inside the window, summed by what the host was
        doing, longest first."""
        by = defaultdict(float)
        end = self.w0
        for t0, t1, _, corr in self.ops:
            if t0 > end:
                by[self._host_op(corr)] += (t0 - end) * 1e-6
            end = max(end, t1)
        if self.w1 > end:
            by["window end"] += (self.w1 - end) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]


@contextlib.contextmanager
def traced(device: torch.device, out: dict):
    """Profile CPU and, on a card, CUDA activity.  The block gets a
    ``window`` context to enter once its warm-up is done (the profiler's own
    start-up costs fall before it): the window starts and ends with a
    synchronize, inside a ``bench.window`` annotation.  On exit
    ``out["trace"]`` holds the window's ``Trace``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    @contextlib.contextmanager
    def window():
        sync()
        with torch.profiler.record_function(WINDOW):
            yield
            sync()

    with torch.profiler.profile(activities=acts) as prof:
        yield window
    fd, path = tempfile.mkstemp(suffix=".json.gz")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with gzip.open(path, "rt") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out["trace"] = Trace(events)

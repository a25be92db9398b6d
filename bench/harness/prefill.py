"""The runner of kind ``prefill``: one closed-loop client of the serving
engine's prefill.

Set-up builds the served model (the config's compute dtype) from the
seed's weights, makes one cycle of requests (``bench/traffic/prefill.py``)
in pinned host memory and prefills one request of each length the cycle
holds, so every shape of the window is warm.  In the window the client
sends the cycle's requests in turn, each as soon as the last one's answer
is on the host: a request is timed from its submission (its prompt rows
in host memory) to its last-token logits on the host, through
``engine.prefill`` with a cache of ``length + cap_extra`` slots.  A
request that raises or answers a non-finite logit counts as failed.  The
serve state and logits of the first cycle's sampled requests are kept for
the comparison, which runs the reference over their prompts once the
window has closed.
"""
from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from bench.harness import compare
from bench.harness.work import Pass


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Run:
    def __init__(self, cell, seed: int, device: torch.device,
                 fault: str | None = None):
        from bench.harness.program import Program

        self.cell, self.seed, self.dev = cell, int(seed), device
        self.cfg, self.mix = cell.config, cell.mix
        self.ref = cell.reference()
        self.specs = self.ref.param_specs(self.cfg)
        self.program = Program(self.cfg, device, fault)
        self.kept: dict = {}
        self.next_request = 0

    def leaf(self, i: int) -> torch.Tensor:
        return self.ref.make_leaf(self.specs[i], self.seed, i, self.dev)

    def setup(self) -> float:
        t0 = time.perf_counter()
        traffic = self.cell.traffic()
        self.requests = traffic.cycle(self.mix, self.cfg, self.seed)
        self.sample = set(traffic.sample(self.mix, self.requests, self.seed))
        pin = self.dev.type == "cuda"
        self.rows = [torch.from_numpy(r.rows).pin_memory() if pin
                     else torch.from_numpy(r.rows) for r in self.requests]
        self.params = self.program.model(self.leaf, [s[0] for s in
                                                     self.specs], None)
        seen = set()
        for i, r in enumerate(self.requests):
            if r.length not in seen:
                seen.add(r.length)
                self._serve(i)
        _sync(self.dev)
        return time.perf_counter() - t0

    def _serve(self, i: int):
        """Prefill request ``i`` of the cycle -> (state, logits on the
        device, logits on the host)."""
        r = self.requests[i]
        tokens = self.rows[i].to(self.dev, non_blocking=True)
        state, logits = self.program.prefill(
            self.params, tokens, r.length + self.mix["cap_extra"])
        return state, logits, logits.float().cpu()

    def _one(self) -> tuple[int, float, bool]:
        """Send the next request -> (its tokens, seconds, answered)."""
        n = self.next_request
        i = n % len(self.requests)
        self.next_request += 1
        t0 = time.perf_counter()
        try:
            state, logits, host = self._serve(i)
            ok = bool(np.isfinite(host.numpy()).all())
        except RuntimeError:
            state = logits = None
            ok = False
        dt = time.perf_counter() - t0
        if ok and n in self.sample:
            self.kept[n] = (state, logits)
        return self.requests[i].rows.size, dt, ok

    def window(self, seconds: float) -> dict:
        _sync(self.dev)
        t0 = time.perf_counter()
        lat, tokens, failed = [], 0, 0
        while time.perf_counter() - t0 < seconds:
            n, dt, ok = self._one()
            lat.append(dt)
            tokens += n
            failed += not ok
        wall = time.perf_counter() - t0
        served = len(lat)
        self.window_units = [Pass(self.mix["batch"], r.length,
                                  self.mix["batch"], False)
                             for r in (self.requests[k % len(self.requests)]
                                       for k in range(served))]
        self.window_s = wall
        p95 = statistics.quantiles(lat, n=20, method="inclusive")[18] \
            if len(lat) > 1 else lat[0]
        return {"attempted": served, "failed": failed,
                "metrics": {"prefill_tokens_per_s": tokens / wall,
                            "prefill_p95_ms": 1e3 * p95}}

    def trace_window(self, window) -> list:
        """One warm-up request, then one cycle's requests inside
        ``window()`` (the profiled sub-window) -> their passes."""
        self._one()
        units = []
        with window():
            for _ in range(len(self.requests)):
                i = self.next_request % len(self.requests)
                units.append(Pass(self.mix["batch"], self.requests[i].length,
                                  self.mix["batch"], False))
                self._one()
        return units

    def release(self) -> None:
        del self.params
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec: str = "f32") -> dict:
        """The reference's serve state and logits of each kept request, in
        ``prec``."""
        ref = self.ref
        out = {}
        with ref.precision(prec):
            params = ref.make_params(self.cfg, self.seed, self.dev)
            for n in sorted(self.kept):
                r = self.requests[n % len(self.requests)]
                tokens = torch.from_numpy(r.rows).to(self.dev)
                out[n] = ref.prefill(self.cfg, params, tokens,
                                     r.length + self.mix["cap_extra"])
        del params
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def numbers(self, ref: dict, read: dict | None = None) -> dict:
        kept = read or self.kept
        return compare.prefill_numbers(
            [(*kept[n], *ref[n]) for n in sorted(ref)])

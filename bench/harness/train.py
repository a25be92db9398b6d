"""The runner of kind ``train``: a training job, closed loop.

Set-up builds the one train state and step (``Program.train_state``) from
the seed's weights and drives it through the mix's ``checked_steps``
steps, each through the same step and feed as the window, and reads what
``correct`` compares (the losses, the first moments after step 1, the
master weights after the last); those reads are not set-up and are left
out of ``setup_s``.  The window then runs the next steps back to back
until ``seconds`` have passed, syncing only at its ends:
``train_tokens_per_s`` is every token of every step it ran over the
window's whole time.  With ``trace`` a few more steps run under the
profiler.  The program's state is then freed and the reference follows
the checked steps from the same weights and rows (``reference.train``).
"""
from __future__ import annotations

import gc
import time

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
        self.feed = cell.traffic().Feed(self.mix, self.cfg, self.seed)
        self.specs = self.ref.param_specs(self.cfg)
        self.paths = [s[0] for s in self.specs]
        self.program = Program(self.cfg, device, fault)
        self.next_step = 0
        self.read = {}

    def leaf(self, i: int) -> torch.Tensor:
        return self.ref.make_leaf(self.specs[i], self.seed, i, self.dev)

    def units(self, steps: int) -> list:
        """The passes ``steps`` steps make: ``grad_accum`` microbatches."""
        n = self.mix["grad_accum"]
        b = self.mix["global_batch"] // n
        s = self.mix["seq_len"]
        return [Pass(b, s, b * s, True)] * (steps * n)

    def step(self):
        batch = self.feed.batch(self.next_step, self.dev)
        self.state, metrics = self.train_step(self.state, batch)
        self.next_step += 1
        return metrics["loss"]

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> float:
        """Build and drive the checked steps -> set-up seconds (the reads
        for the comparison excluded); ``phases`` holds its parts."""
        t0 = time.perf_counter()
        self.state, self.train_step = self.program.train_state(
            self.leaf, self.paths, self.mix)
        _sync(self.dev)
        self.phases = {"state_s": time.perf_counter() - t0, "steps_s": []}
        losses, reads = [], 0.0
        b1 = self.mix["optimizer"]["b1"]
        for k in range(self.mix["checked_steps"]):
            s0 = time.perf_counter()
            losses.append(self.step())
            _sync(self.dev)
            self.phases["steps_s"].append(time.perf_counter() - s0)
            if k == 0:
                r0 = time.perf_counter()
                self.read["grad_norms"] = {
                    p: float(torch.linalg.vector_norm(m.float())) / (1 - b1)
                    for p, m in zip(self.paths,
                                    self.program.first_moments(self.state))}
                reads += time.perf_counter() - r0
        _sync(self.dev)
        r0 = time.perf_counter()
        self.read["losses"] = [float(x) for x in losses]
        self.read["update_norms"] = self._update_norms()
        reads += time.perf_counter() - r0
        return time.perf_counter() - t0 - reads

    @torch.no_grad()
    def _update_norms(self) -> dict:
        leaves = self.program.leaves(self.state["params"])
        out = {}
        for i, lf in enumerate(leaves):
            out[self.paths[i]] = float(torch.linalg.vector_norm(
                lf.gather().float() - self.leaf(i)))
        return out

    # -- the window ------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        _sync(self.dev)
        t0 = time.perf_counter()
        losses = []
        while time.perf_counter() - t0 < seconds:
            losses.append(self.step())
        _sync(self.dev)
        wall = time.perf_counter() - t0
        n = len(losses)
        finite = torch.isfinite(torch.stack(losses).float()).cpu()
        self.window_units = self.units(n)
        self.window_s = wall
        return {"attempted": n, "failed": int((~finite).sum()),
                "metrics": {"train_tokens_per_s":
                            n * self.feed.tokens_per_step / wall}}

    def trace_window(self, window) -> list:
        """One warm-up step, then the mix's ``trace_steps`` steps inside
        ``window()`` (the profiled sub-window) -> their passes."""
        self.step()
        n = self.mix["trace_steps"]
        with window():
            for _ in range(n):
                self.step()
        return self.units(n)

    def release(self) -> None:
        del self.state, self.train_step
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ---------------------------------------------------------

    def reference(self, prec: str = "f32", fault: str | None = None) -> dict:
        """The reference's readings of the checked steps, in ``prec``;
        ``fault="half_batch"`` puts the fault in the reference's place."""
        ref = self.ref
        job = dict(self.mix["optimizer"], grad_accum=self.mix["grad_accum"])
        batches = []
        for k in range(self.mix["checked_steps"]):
            rows = self.feed.batch(k, self.dev)
            t, lab = rows["tokens"], rows["labels"]
            if fault == "half_batch":
                half = t.shape[0] // 2
                t, lab = torch.cat([t[:half]] * 2), torch.cat([lab[:half]] * 2)
            batches.append((t, lab))
        with ref.precision(prec):
            params = ref.make_params(self.cfg, self.seed, self.dev)
            out = ref.train(self.cfg, job, params, batches)
            with torch.no_grad():
                out["update_norms"] = {
                    p: float(torch.linalg.vector_norm(params[p]
                                                      - self.leaf(i)))
                    for i, p in enumerate(self.paths)}
        del params
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def numbers(self, ref: dict, read: dict | None = None) -> dict:
        return compare.train_numbers(read or self.read, ref)

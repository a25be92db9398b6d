"""The system under test: the PyTorch / CUDA port, ``repro_torch``, loaded
from the checkout's ``src/``.  This is the only module of the benchmark
that imports it.

The benchmark hands the program its weights leaf by leaf in the
checkpoint layout both of the repo's packages use (layers stacked, dense
weights ``(d_in, d_out)``), through the program's own carrier
(``models.convert.reference_leaves``), and reads back what it compares
(the optimizer's moments, the master weights, the serve state) the same
way.  Planted faults (``FAULTS``) break the timed path underneath, for the
tests and the readings that show ``correct`` catches them; a benchmark run
never sets one.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Callable

import torch

SRC = Path(__file__).resolve().parents[2] / "src"

FAULTS = ("unchanged", "half_batch", "altered")


def _import():
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401


class Program:
    def __init__(self, cfg: dict, device: torch.device,
                 fault: str | None = None):
        _import()
        from repro_torch import configs

        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        base = configs.get(cfg["program"]).make_config()
        fields = {f.name for f in dataclasses.fields(base)} - {"name"}
        over = {k: tuple(v) if isinstance(v, list) else v
                for k, v in cfg.items() if k in fields}
        self.cfg = dataclasses.replace(base, **over)
        self.device = device
        self.fault = fault

    # -- weights -----------------------------------------------------------

    def model(self, leaf: Callable[[int], torch.Tensor], paths: list,
              dtype: torch.dtype | None):
        """The program's model on the device, dense weights in ``dtype``
        (None: the config's compute dtype), leaf ``i`` of ``paths`` (the
        benchmark's sorted leaf paths) written from ``leaf(i)``."""
        from repro_torch.models import convert
        from repro_torch.models import transformer as tfm
        from repro_torch.models.common import META

        model = tfm.init_params(self.cfg, META, dtype).to_empty(
            device=self.device)
        leaves = convert.reference_leaves(self.cfg, model)
        if [lf.path for lf in leaves] != list(paths):
            raise RuntimeError("the program's parameter tree differs from "
                               "the benchmark's: "
                               f"{[lf.path for lf in leaves]} vs {paths}")
        for i, lf in enumerate(leaves):
            value = leaf(i)
            if tuple(value.shape) != lf.shape:
                raise RuntimeError(f"leaf {lf.path}: {tuple(value.shape)} "
                                   f"vs the program's {lf.shape}")
            lf.scatter(value)
            del value
        return model

    def leaves(self, model) -> list:
        from repro_torch.models import convert

        return convert.reference_leaves(self.cfg, model)

    # -- training ------------------------------------------------------------

    def train_state(self, leaf, paths, job: dict):
        """``(state, train_step)`` as ``launch/train.py`` builds them, from
        the benchmark's weights: f32 master weights that require
        gradients, zero AdamW moments, step 0; the step with the job's
        ``grad_accum`` and clip."""
        from repro_torch.models.common import ShardRules
        from repro_torch.training import optimizer as opt_mod
        from repro_torch.training import step as step_mod

        opt = job["optimizer"]
        oc = opt_mod.AdamWConfig(
            lr=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
            weight_decay=opt["weight_decay"], warmup_steps=opt["warmup"],
            total_steps=opt["total_steps"], min_lr_frac=opt["min_lr_frac"],
            quantize_state=opt["moments"] == "int8")
        model = self.model(leaf, paths, torch.float32)
        for t in model.parameters():
            t.requires_grad_(True)
        state = {"params": model,
                 "opt": opt_mod.init_state(oc, self.leaves(model)),
                 "step": 0}
        step = step_mod.make_train_step(self.cfg, ShardRules(), oc,
                                        grad_accum=job["grad_accum"],
                                        clip_norm=opt["clip"])
        return state, self._planted_step(step)

    def _planted_step(self, step):
        if self.fault == "half_batch":
            def half(state, batch):
                rows = next(iter(batch.values())).shape[0] // 2
                return step(state, {k: torch.cat([v[:rows]] * 2)
                                    for k, v in batch.items()})
            return half
        if self.fault == "unchanged":
            def unchanged(state, batch):
                keep = [t.detach().clone()
                        for t in state["params"].parameters()]
                opt = state["opt"]
                new, metrics = step(state, batch)
                with torch.no_grad():
                    for t, old in zip(new["params"].parameters(), keep):
                        t.copy_(old)
                return dict(new, opt=opt), metrics
            return unchanged
        return step

    def first_moments(self, state) -> list[torch.Tensor]:
        """The AdamW first moment of each leaf, in the benchmark's order."""
        from repro_torch.training.optimizer import Quant8

        return [m.decode() if isinstance(m, Quant8) else m
                for m in state["opt"]["m"]]

    # -- serving -------------------------------------------------------------

    def prefill(self, params, tokens: torch.Tensor, cap: int):
        """``engine.prefill`` of ``tokens (b, s)`` -> (state, last-token
        logits)."""
        from repro_torch.serving import engine

        if self.fault == "half_batch":
            half = tokens.shape[0] // 2
            state, logits = engine.prefill(self.cfg, params,
                                           {"tokens": tokens[:half]}, cap)
            state = {k: torch.cat([v] * 2, dim=1) if torch.is_tensor(v)
                     else v for k, v in state.items()}
            return state, torch.cat([logits] * 2)
        state, logits = engine.prefill(self.cfg, params, {"tokens": tokens},
                                       cap)
        if self.fault == "unchanged":
            state = engine.init_state(self.cfg, tokens.shape[0], cap,
                                      tokens.device)
        elif self.fault == "altered":
            # the first prompt's token is one from across the vocabulary
            logits = logits.clone()
            other = (int(torch.argmax(logits[0])) + logits.shape[1] // 2) \
                % logits.shape[1]
            logits[0, other] = logits[0].max() + 1.0
        return state, logits

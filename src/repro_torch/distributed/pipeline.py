"""GPipe-style pipeline-parallel stage executor.

Counterpart of ``repro/distributed/pipeline.py``.  Each stage of the
``axis`` of a mesh holds one stage's parameters on its device;
microbatches stream through with the classic GPipe schedule (fill, steady
state, drain) over ``n_micro + n_stages - 1`` ticks.  The reference runs
it under ``shard_map``, passing activations with ``ppermute``; here one
process enqueues each stage's work of a tick on its device's stream and
moves its output to the next stage's device with ``.to(next_device,
non_blocking=True)``.  A stage computes only on live ticks (the reference
computes on its dead ticks and discards the result).  The last stage's
outputs come back replicated (``Sharded``, spec ``P()``).

The port's own blocks run as stages: ``stage_layers`` splits a model's
``Block`` s into stages (each a ``Stage``, which keeps the blocks' layer
indices, so hybrid global layers stay global), and ``blocks_stage_fn`` is
the stage function that runs them.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from repro_torch.distributed.partition import tree_map
from repro_torch.launch.mesh import Mesh, device_put
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ModelConfig


class Stage(nn.Module):
    """One pipeline stage of a model's layers: its ``blocks`` and their
    ``layer_ids`` in the whole stack."""

    def __init__(self, blocks: Sequence[tfm.Block], layer_ids: Sequence[int]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.layer_ids = tuple(layer_ids)


def stage_layers(layers: Sequence[tfm.Block], n_stages: int) -> list[Stage]:
    """``layers`` in ``n_stages`` equal consecutive stages."""
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers do not split into "
                         f"{n_stages} stages")
    per = len(layers) // n_stages
    return [Stage(layers[s * per:(s + 1) * per],
                  range(s * per, (s + 1) * per)) for s in range(n_stages)]


def blocks_stage_fn(cfg: ModelConfig, causal: bool = True) -> Callable:
    """``stage_fn(stage, x)``: the stage's blocks over hidden states ``x (mb,
    s, d)`` at positions ``0 .. s - 1``, as ``tfm.run_stack`` runs them."""
    def stage_fn(stage: Stage, x: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(x.shape[1], device=x.device)
        for i, p in zip(stage.layer_ids, stage.blocks):
            x, _ = tfm.block_forward(cfg, p, x, pos,
                                     is_global=i in cfg.global_layers,
                                     causal=causal)
        return x

    return stage_fn


def pipeline_forward(mesh: Mesh, stage_fn: Callable, axis: str = "stage"):
    """Returns ``f(stacked_params, microbatches) -> outputs``.

    ``stacked_params``: a tree of tensors with a leading ``(n_stages,
    ...)`` axis, or a sequence of ``n_stages`` per-stage parameters (e.g.
    ``stage_layers``' stages); stage s's part moves to its device.
    ``microbatches``: ``(n_micro, mb, ...)``; outputs likewise, replicated
    over the mesh.
    """
    devs = mesh.axis_devices(axis)
    n_stages = len(devs)

    def place(params, s: int):
        if isinstance(params, (list, tuple, nn.ModuleList)):
            if len(params) != n_stages:
                raise ValueError(f"{len(params)} stages of parameters on a "
                                 f"{n_stages}-stage {axis!r} axis")
            part = params[s]
            return part.to(devs[s]) if isinstance(part, nn.Module) else \
                tree_map(lambda t: t.to(devs[s]), part)
        return tree_map(lambda t: t[s].to(devs[s]), params)

    def f(stacked_params, microbatches):
        stages = [place(stacked_params, s) for s in range(n_stages)]
        n_micro = len(microbatches)
        outs = [None] * n_micro
        inbox = [None] * n_stages
        for t in range(n_micro + n_stages - 1):
            nxt = [None] * n_stages
            for s in range(n_stages):
                m = t - s
                if not 0 <= m < n_micro:
                    continue
                x = microbatches[m].to(devs[0], non_blocking=True) if s == 0 \
                    else inbox[s]
                y = stage_fn(stages[s], x)
                if s == n_stages - 1:
                    outs[m] = y
                else:
                    nxt[s + 1] = y.to(devs[s + 1], non_blocking=True)
            inbox = nxt
        return device_put(torch.stack([o.to(devs[0]) for o in outs]), mesh)

    return f

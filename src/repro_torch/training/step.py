"""Train step: microbatched grad accumulation, clipping, AdamW.

Counterpart of ``repro/training/step.py``.  ``make_train_step`` returns
``train_step(state, batch) -> (state, metrics)`` with the reference's
arithmetic: the ``grad_accum`` microbatches' gradients summed in f32 and
divided by ``grad_accum`` (the loss likewise), the metrics of the last
microbatch, the gradients clipped to ``clip_norm`` by their global norm,
then one AdamW step.

PyTorch's idiom in place of JAX's: gradient accumulation is a Python loop
of ``loss.backward()`` calls summing into each parameter's f32 ``.grad``
(the reference's ``lax.scan`` over an f32 buffer); the state is updated in
place (the parameters are the model's tensors, written by ``copy_``), so no
second copy of the parameters is held.  The optimizer walks the
reference's leaves (``convert.reference_leaves``: layers stacked, dense
weights ``(d_in, d_out)``) one at a time, gathering each leaf's parameter
and gradient, so its moments, its ``ndim >= 2`` decay rule and its 8-bit
blocks are the reference's, and one leaf's temporaries are alive at once.

The port has no ``ShardRules`` (one card), so ``make_train_step`` takes
no ``rules``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ModelConfig
from repro_torch.models import convert
from repro_torch.training import optimizer as opt_mod


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / max(norm, 1e-9))``."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tensors: list[torch.Tensor], max_norm: float):
    """``(clipped tensors, norm)``: each scaled by ``clip_scale`` in its
    own dtype."""
    norm = global_norm(tensors)
    scale = clip_scale(norm, max_norm)
    return [x * scale.to(x.dtype) for x in tensors], norm


class _CastBf16(torch.nn.Module):
    """Calls ``loss_fn(params, batch)`` with the f32 matrices of the
    reference's tree (``ndim >= 2`` there, layers stacked) cast to bf16, by
    ``torch.func.functional_call``: the cast is part of the graph, so the
    f32 masters get the gradients."""

    def __init__(self, params: torch.nn.Module, loss_fn: Callable):
        super().__init__()
        self.params, self.loss_fn = params, loss_fn

    def forward(self, batch):
        return self.loss_fn(self.params, batch)


def _bf16_names(cfg: ModelConfig, model: tfm.Transformer) -> set:
    """Names of the parameters whose reference leaf is an f32 matrix."""
    ids = {id(t) for leaf in convert.reference_leaves(cfg, model)
           if len(leaf.shape) >= 2 for t in leaf.tensors}
    return {name for name, t in model.named_parameters()
            if id(t) in ids and t.dtype == torch.float32}


def make_train_step(cfg: ModelConfig, opt_cfg: opt_mod.AdamWConfig,
                    grad_accum: int = 1, clip_norm: float = 1.0,
                    loss_fn: Callable | None = None,
                    cast_params_bf16: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state = {"params": Transformer, "opt": {...}, "step": int}``
    (``init_train_state``); ``batch`` leaves have leading dim
    global_batch, split into ``grad_accum`` microbatches.  The returned
    state holds the same (updated) model."""
    loss_fn = loss_fn or (lambda params, batch: tfm.forward_train(
        cfg, params, batch))
    if cast_params_bf16:
        base_loss = loss_fn

        def loss_fn(params, batch):  # noqa: F811
            wrapper = _CastBf16(params, base_loss)
            cast = {f"params.{n}": params.get_parameter(n).to(torch.bfloat16)
                    for n in _bf16_names(cfg, params)}
            return torch.func.functional_call(wrapper, cast, (batch,),
                                              strict=False)

    def train_step(state: dict, batch: dict):
        model = state["params"]
        leaves = convert.reference_leaves(cfg, model)
        params = [t for leaf in leaves for t in leaf.tensors]
        for t in params:
            t.grad = None
        for k, v in batch.items():
            if v.shape[0] % grad_accum:
                raise ValueError(f"batch leaf {k!r} of {v.shape[0]} rows "
                                 f"does not split into {grad_accum} "
                                 "microbatches")
        micro = {k: torch.chunk(v, grad_accum) for k, v in batch.items()}
        loss_sum = None
        for i in range(grad_accum):
            loss, metrics = loss_fn(model, {k: v[i] for k, v in micro.items()})
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        metrics = {k: v.detach() for k, v in metrics.items()}
        for t in params:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
            elif grad_accum > 1:
                t.grad.div_(grad_accum)
        if grad_accum > 1:
            loss_sum = loss_sum / grad_accum
        # clip_by_global_norm, in place on the .grad buffers.
        gnorm = global_norm(t.grad for t in params)
        scale = clip_scale(gnorm, clip_norm)
        for t in params:
            t.grad.mul_(scale.to(t.grad.dtype))

        opt = state["opt"]
        step, lr, bc1, bc2 = opt_mod.step_scalars(opt_cfg, opt["step"])
        new_m, new_v = [], []
        for leaf, m, v in zip(leaves, opt["m"], opt["v"], strict=True):
            p, g = leaf.gather(), leaf.gather(lambda t: t.grad)
            new_p, m, v = opt_mod.update_leaf(opt_cfg, p, g, m, v, lr, bc1,
                                              bc2)
            leaf.scatter(new_p)
            new_m.append(m)
            new_v.append(v)
        for t in params:
            t.grad = None
        metrics = dict(metrics, loss=loss_sum, grad_norm=gnorm,
                       lr=opt_mod.lr_schedule(opt_cfg, step))
        return {"params": model, "opt": {"m": new_m, "v": new_v,
                                         "step": step},
                "step": state["step"] + 1}, metrics

    return train_step


def init_train_state(cfg: ModelConfig, opt_cfg: opt_mod.AdamWConfig,
                     generator: torch.Generator | int = 0,
                     device=None) -> dict:
    """f32 master parameters drawn by ``tfm.init_params`` from
    ``generator`` (or a seed, on ``device``: the card by default), with
    gradients on, zero moments in the reference's leaf layout and step
    0."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(
            device=resolve_device(device)).manual_seed(int(generator))
    model = tfm.init_params(cfg, generator, dtype=torch.float32)
    for t in model.parameters():
        t.requires_grad_(True)
    return {"params": model,
            "opt": opt_mod.init_state(opt_cfg, convert.reference_leaves(cfg, model)),
            "step": 0}

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

While ``torch.profiler`` records, each step marks its phases
(``tracing.span``), the same with and without a mesh: ``train.forward``
around each microbatch's forward, ``train.backward`` around its
``loss.backward()`` (remat's recompute runs inside it, on autograd's
thread, while this one waits), and ``train.optimizer`` from the average
and clip through the AdamW leaves and the gradient reset: ``2 *
grad_accum + 1`` spans a step.

``make_train_step(cfg, rules, opt_cfg, ...)`` takes the reference's
``ShardRules`` second.  Without a mesh they change nothing, as in the
reference.  With ``mesh=`` (``launch.mesh``) the step is the port's answer
to the reference's ``jit(train_step, in_shardings=...)`` under a mesh:

* the state's leaves are ``Sharded`` by the fitted ``partition.param_specs``
  / ``opt_specs`` (``shard_train_state``), in the reference's tree layout;
* the batch splits over ``rules.dp``'s axes: share i takes rows ``[i B /
  dp, (i + 1) B / dp)`` and, inside them, ``grad_accum`` microbatches;
* each share gathers its parameters onto the device at its mesh position
  ``(i, 0, ...)`` and runs forward and backward there;
* the microbatch gradients are summed plainly in one chain in microbatch
  order, the running sum handed from share to share (``_accumulate``, as
  without a mesh), then moved to the first share's device, averaged and
  clipped as without a mesh (``_average_and_clip``);
* each shard of the state updates on its own device, in place (as the
  unsharded step updates its model): AdamW is elementwise, and ``Quant8``
  blocks shard whole over fsdp (their flat range of the leaf updates with
  them), so the update is exact.

So on one device type the mesh step at dp = 2 equals the unsharded step at
``grad_accum=2`` bit for bit: the microbatches, the order of the sums and
every elementwise update are the same.  The ``"model"`` axis places storage
only: a share's compute runs whole on one device.  The port has no
tensor-parallel partitioner (no SPMD compiler), and one card could not test
one.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import device_key, resolve_device
from repro_torch.launch.mesh import Mesh, Sharded, device_put

# ``distributed/`` reads this package's optimizer, so its modules are
# imported where they are used.
from repro_torch.models import transformer as tfm
from repro_torch.models.common import META, ModelConfig, ShardRules
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


def make_train_step(cfg: ModelConfig, rules: ShardRules | None,
                    opt_cfg: opt_mod.AdamWConfig, grad_accum: int = 1,
                    clip_norm: float = 1.0, loss_fn: Callable | None = None,
                    cast_params_bf16: bool = False, *,
                    mesh: Mesh | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state = {"params": Transformer, "opt": {...}, "step": int}``
    (``init_train_state``); ``batch`` leaves have leading dim
    global_batch, split into ``grad_accum`` microbatches.  The returned
    state holds the same (updated) model.  With ``mesh``, ``state`` is
    ``shard_train_state``'s and the step is the mesh leg (module
    docstring); ``rules=None`` means ``ShardRules()``."""
    rules = rules or ShardRules()
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

    if mesh is not None:
        return _mesh_train_step(cfg, rules, opt_cfg, mesh, grad_accum,
                                clip_norm, loss_fn)

    def train_step(state: dict, batch: dict):
        model = state["params"]
        leaves = convert.reference_leaves(cfg, model)
        params = [t for leaf in leaves for t in leaf.tensors]
        loss, metrics = _accumulate(loss_fn, model, params,
                                    _microbatches(batch, grad_accum))
        with tracing.span("train.optimizer"):
            loss, gnorm = _average_and_clip(params, loss, grad_accum,
                                            clip_norm)
            opt = state["opt"]
            step, lr, bc1, bc2 = opt_mod.step_scalars(opt_cfg, opt["step"])
            new_m, new_v = [], []
            for leaf, m, v in zip(leaves, opt["m"], opt["v"], strict=True):
                p, g = leaf.gather(), leaf.gather(lambda t: t.grad)
                new_p, m, v = opt_mod.update_leaf(opt_cfg, p, g, m, v, lr,
                                                  bc1, bc2)
                leaf.scatter(new_p)
                new_m.append(m)
                new_v.append(v)
            for t in params:
                t.grad = None
        return {"params": model, "opt": {"m": new_m, "v": new_v,
                                         "step": step},
                "step": state["step"] + 1}, _step_metrics(
                    opt_cfg, metrics, loss, gnorm, step)

    return train_step


def _accumulate(loss_fn: Callable, model, tensors: list, micro: dict,
                carry: list | None = None, loss_sum=None):
    """Forward and backward of ``model`` on each of ``micro``'s
    microbatches in order, each one's gradients summed into the f32
    ``.grad`` of ``tensors`` by autograd, on top of ``carry`` (the running
    sums of the microbatches before these, moved to ``tensors``' devices)
    and the loss onto ``loss_sum`` -> ``(loss_sum, metrics of the last
    microbatch)``.  The sum is one chain in microbatch order, however the
    microbatches are split over devices."""
    for i, t in enumerate(tensors):
        g = None if carry is None else carry[i]
        t.grad = None if g is None else g.to(t.device)
    n = len(next(iter(micro.values())))
    for j in range(n):
        with tracing.span("train.forward"):
            loss, metrics = loss_fn(model, {k: v[j] for k, v in micro.items()})
        with tracing.span("train.backward"):
            loss.backward()
        loss = loss.detach()
        loss_sum = loss if loss_sum is None else \
            loss_sum + loss.to(loss_sum.device)
    return loss_sum, {k: v.detach() for k, v in metrics.items()}


def _average_and_clip(tensors: list, loss_sum: torch.Tensor, n: int,
                      clip_norm: float):
    """The summed ``.grad`` of ``tensors`` (zeros where a tensor got none)
    and the summed loss divided by the ``n`` microbatches, then the
    gradients clipped to ``clip_norm`` by their global norm, in place ->
    ``(loss, norm)``."""
    for t in tensors:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        elif n > 1:
            t.grad.div_(n)
    if n > 1:
        loss_sum = loss_sum / n
    gnorm = global_norm(t.grad for t in tensors)
    scale = clip_scale(gnorm, clip_norm)
    for t in tensors:
        t.grad.mul_(scale.to(t.grad.dtype))
    return loss_sum, gnorm


def _step_metrics(opt_cfg, metrics: dict, loss, gnorm, step) -> dict:
    return dict(metrics, loss=loss, grad_norm=gnorm,
                lr=opt_mod.lr_schedule(opt_cfg, step))


def _microbatches(batch: dict, n: int) -> dict:
    """Each batch leaf as ``n`` equal row blocks."""
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch leaf {k!r} of {v.shape[0]} rows does "
                             f"not split into {n} microbatches")
    return {k: torch.chunk(v, n) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The mesh leg
# ---------------------------------------------------------------------------


def state_tree(cfg: ModelConfig, state: dict) -> dict:
    """A port train state in the reference's tree layout (what
    ``shard_train_state`` lays out and ``checkpoint.save`` writes):
    ``{"params", "opt": {"m", "v", "step"}, "step"}`` with the parameters
    gathered per leaf (layers stacked, dense weights ``(d_in, d_out)``)."""
    from repro_torch.distributed import partition

    leaves = convert.reference_leaves(cfg, state["params"])
    paths = [leaf.path for leaf in leaves]
    opt = state["opt"]
    return {"params": partition.nest((leaf.path, leaf.gather())
                                     for leaf in leaves),
            "opt": {"m": partition.nest(zip(paths, opt["m"])),
                    "v": partition.nest(zip(paths, opt["v"])),
                    "step": opt["step"]},
            "step": state["step"]}


def train_state_specs(cfg: ModelConfig, rules: ShardRules,
                      opt_cfg: opt_mod.AdamWConfig, axis_sizes: dict) -> dict:
    """The fitted specs of a train state's tree on a mesh of
    ``axis_sizes``: ``param_specs`` / ``opt_specs`` (``Quant8`` moments
    over fsdp), the steps replicated."""
    from repro_torch.distributed import partition

    p_shapes = partition.param_shapes(
        cfg, tfm.init_params(cfg, META, torch.float32))
    o_shapes = partition.opt_shapes(opt_cfg, p_shapes)
    p_specs = partition.fit_tree(
        partition.param_specs(cfg, p_shapes, rules), p_shapes, axis_sizes)
    o_specs = partition.fit_tree(
        partition.opt_specs(cfg, p_specs, o_shapes, rules), o_shapes,
        axis_sizes)
    return {"params": p_specs, "opt": o_specs,
            "step": partition.P()}


def shard_train_state(cfg: ModelConfig, rules: ShardRules | None,
                      opt_cfg: opt_mod.AdamWConfig, state: dict,
                      mesh: Mesh) -> dict:
    """A train state on ``mesh``: ``state`` is a port state
    (``init_train_state``), a reference-layout tree (``state_tree``, a
    checkpoint's restore) or a state already on a mesh; every leaf is
    ``Sharded`` by its fitted spec."""
    from repro_torch.distributed import elastic

    if not isinstance(state["params"], dict):
        state = state_tree(cfg, state)
    step = state["step"]               # a host int, as the port's states keep it
    state = dict(state, step=int(step.full() if isinstance(step, Sharded)
                                 else step))
    specs = train_state_specs(cfg, rules or ShardRules(), opt_cfg,
                              mesh.shape)
    return elastic.reshard(state, specs, mesh)


def _dp_shares(rules: ShardRules, mesh: Mesh) -> list[torch.device]:
    """The device of each data-parallel share: mesh position ``(i, 0,
    ...)`` over ``rules.dp``'s axes, the first major."""
    axes = [a for a in rules.dp if a in mesh.shape]
    sizes = [mesh.shape[a] for a in axes]
    out = []
    for i in range(math.prod(sizes)):
        where = dict(zip(axes, np.unravel_index(i, sizes)))
        out.append(mesh.device_at([where.get(a, 0)
                                   for a in mesh.axis_names]))
    return out


@torch.no_grad()
def _update_sharded(opt_cfg, p: Sharded, g: torch.Tensor, m, v, scalars
                    ) -> None:
    """One leaf's AdamW update, shard by shard on each shard's device, in
    place.  f32 moments share the parameter's spec; ``Quant8`` moments are
    blocks of the flattened leaf, so their flat range of the parameter and
    gradient updates with them."""
    ndim = p.ndim

    def on(dev):
        return [t.to(dev) for t in scalars]

    if not isinstance(m, opt_mod.Quant8):
        done = set()
        for pos, pt in enumerate(p.shards):
            if id(pt) in done:
                continue
            done.add(id(pt))
            mt, vt = m.shards[pos], v.shards[pos]
            new = opt_mod.update_leaf(opt_cfg, pt, g[p.index(pos)].to(
                pt.device), mt, vt, *on(pt.device), ndim=ndim)
            for old, value in zip((pt, mt, vt), new):
                old.copy_(value)
        return

    block = m.q.shape[1]
    n = math.prod(p.shape)
    p_flat = p.full().reshape(-1)
    g_flat = g.reshape(-1)
    new_p = torch.empty_like(p_flat)
    done = set()
    for pos, mq in enumerate(m.q.shards):
        if id(mq) in done:
            continue
        done.add(id(mq))
        rows = m.q.index(pos)[0]
        s, e = rows.start * block, min(rows.stop * block, n)
        dev = mq.device
        codes = [opt_mod.Quant8(x.q.shards[pos], x.hi.shards[pos], (e - s,))
                 for x in (m, v)]
        piece, nm, nv = opt_mod.update_leaf(
            opt_cfg, p_flat[s:e].to(dev), g_flat[s:e].to(dev), *codes,
            *on(dev), ndim=ndim)
        new_p[s:e] = piece.to(new_p.device)
        for old, value in zip(codes, (nm, nv)):
            old.q.copy_(value.q)
            old.hi.copy_(value.hi)
    new_p = new_p.reshape(p.shape)
    for idx, t in p.unique():
        t.copy_(new_p[idx])


def _mesh_train_step(cfg: ModelConfig, rules: ShardRules,
                     opt_cfg: opt_mod.AdamWConfig, mesh: Mesh,
                     grad_accum: int, clip_norm: float, loss_fn: Callable):
    from repro_torch.distributed import partition

    shares = _dp_shares(rules, mesh)
    models: dict = {}

    def model_on(dev):
        """The compute model of a share's device (one per distinct
        device), its parameters overwritten by each share's gather."""
        key = str(device_key(dev))
        if key not in models:
            model = tfm.init_params(cfg, META, torch.float32).to_empty(
                device=dev)
            for t in model.parameters():
                t.requires_grad_(True)
            models[key] = (model, convert.reference_leaves(cfg, model))
        return models[key]

    def train_step(state: dict, batch: dict):
        flat_p = partition.tree_leaves(state["params"])
        opt = state["opt"]
        flat_m = partition.tree_leaves(opt["m"], is_leaf=_is_moment)
        flat_v = partition.tree_leaves(opt["v"], is_leaf=_is_moment)
        per_share = _microbatches(batch, len(shares))
        carry, loss_sum = None, None
        for i, dev in enumerate(shares):
            model, leaves = model_on(dev)
            for leaf, p in zip(leaves, flat_p, strict=True):
                leaf.scatter(p.full(dev))
            tensors = [t for leaf in leaves for t in leaf.tensors]
            micro = _microbatches({k: v[i].to(dev)
                                   for k, v in per_share.items()}, grad_accum)
            loss_sum, metrics = _accumulate(loss_fn, model, tensors, micro,
                                            carry, loss_sum)
            carry = [t.grad for t in tensors]
        red = shares[0]
        model, leaves = model_on(red)
        tensors = [t for leaf in leaves for t in leaf.tensors]
        for t, g in zip(tensors, carry):
            t.grad = None if g is None else g.to(red)
        del carry
        for other, _ in models.values():
            if other is not model:
                for t in other.parameters():
                    t.grad = None
        metrics = {k: v.to(red) for k, v in metrics.items()}
        with tracing.span("train.optimizer"):
            loss, gnorm = _average_and_clip(tensors, loss_sum.to(red),
                                            len(shares) * grad_accum,
                                            clip_norm)
            o_step = opt["step"].full() \
                if isinstance(opt["step"], Sharded) else opt["step"]
            step, lr, bc1, bc2 = opt_mod.step_scalars(opt_cfg,
                                                      o_step.to(red))
            for leaf, p, m, v in zip(leaves, flat_p, flat_m, flat_v,
                                     strict=True):
                g = leaf.gather(lambda t: t.grad)
                for t in leaf.tensors:
                    t.grad = None
                _update_sharded(opt_cfg, p, g, m, v, (lr, bc1, bc2))
        return {"params": state["params"],
                "opt": {"m": opt["m"], "v": opt["v"],
                        "step": device_put(step, mesh)},
                "step": state["step"] + 1}, _step_metrics(
                    opt_cfg, metrics, loss, gnorm, step)

    return train_step


def _is_moment(x) -> bool:
    return isinstance(x, (Sharded, opt_mod.Quant8))


def init_train_state(cfg: ModelConfig, opt_cfg: opt_mod.AdamWConfig,
                     generator: torch.Generator | int = 0,
                     device=None) -> dict:
    """f32 master parameters drawn by ``tfm.init_params`` from
    ``generator`` (or a seed, on ``device``: the card by default; or
    ``common.META``, a state on the meta device), with gradients on, zero
    moments in the reference's leaf layout and step 0."""
    if isinstance(generator, int):
        generator = torch.Generator(
            device=resolve_device(device)).manual_seed(int(generator))
    model = tfm.init_params(cfg, generator, dtype=torch.float32)
    for t in model.parameters():
        t.requires_grad_(True)
    return {"params": model,
            "opt": opt_mod.init_state(opt_cfg, convert.reference_leaves(cfg, model)),
            "step": 0}

"""The weight carrier: the reference's parameter tree -> the port's modules.

``params_from_numpy(cfg, tree, device, dtype)`` takes the tree that
``repro.models.transformer.init_params`` returns, already turned into numpy
arrays by the caller (``jax.tree.map(np.asarray, params)``), with the
layers stacked along a leading axis ``(L, ...)``, and returns the port's
``Transformer``, for every family: a block's keys (``norm1``, ``attn``,
``norm2``, ``mlp``, ``moe``, ``ssm``, ``norm_x``, ``xattn``) become the
``Block``'s submodules of the same names, and whisper's ``enc_layers`` /
``enc_norm`` the encoder's.  Dense weights arrive as ``(d_in, d_out)`` (the
reference computes ``x @ w``) and are stored transposed, in
``common.DENSE_LAYOUT`` ``(d_out, d_in)``, in ``dtype`` (default: the
config's compute dtype); the MoE's expert weights keep the reference's
``(e, d, f)`` / ``(e, f, d)`` layout, in ``dtype``.  Norm scales, the MoE
router, the conv kernel and the SSM vectors stay f32, as the reference
keeps and applies them.

The way back, for checkpoints that either package restores:
``reference_leaves(cfg, model)`` lists the reference tree's leaves in its
flatten order (keys sorted), each with the port's tensors it stacks and
whether they are transposed; ``params_to_numpy`` restacks the port's
modules into the reference's ``layers`` / ``enc_layers`` tree, and
``train_state_to_numpy`` / ``train_state_from_numpy`` carry a whole train
state (parameters, AdamW moments, f32 or ``Quant8``, and both steps).  The
optimizer's moments are kept in the reference's leaf layout already
(``training.step``), so they cross as they are.  This module imports no
JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import Dense, ModelConfig, Norm
from repro_torch.training.optimizer import Quant8


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                        dtype=dtype)


def _dense(tree: dict, i: int, device, dtype) -> Dense:
    w = np.asarray(tree["w"][i])
    p = Dense(w.shape[0], w.shape[1], "b" in tree, device=device, dtype=dtype)
    p.weight.data = _tensor(w.T, device, dtype)
    if "b" in tree:
        p.bias.data = _tensor(tree["b"][i], device, dtype)
    return p


def _norm(cfg: ModelConfig, tree: dict, i, device) -> Norm:
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    scale = pick(tree["scale"])
    p = Norm(cfg, len(scale), device)
    p.scale.data = _tensor(scale, device, torch.float32)
    if p.bias is not None:
        p.bias.data = _tensor(pick(tree["bias"]), device, torch.float32)
    return p


def _attention(tree: dict, i: int, device, dtype) -> attn.Attention:
    return attn.Attention(*(_dense(tree[n], i, device, dtype)
                            for n in ("wq", "wk", "wv", "wo")))


def _mlp(tree: dict, i: int, device, dtype) -> mlp_mod.MLP:
    return mlp_mod.MLP(*(_dense(tree[n], i, device, dtype)
                         for n in ("wg", "wu", "wd")))


def _moe(tree: dict, i: int, device, dtype) -> mlp_mod.MoE:
    shared = tree.get("shared")
    return mlp_mod.MoE(
        _dense(tree["router"], i, device, torch.float32),
        *(_tensor(tree[n][i], device, dtype) for n in ("wg", "wu", "wd")),
        None if shared is None else _mlp(shared, i, device, dtype))


def _ssm(cfg: ModelConfig, tree: dict, i: int, device, dtype) -> ssm_mod.SSM:
    p = ssm_mod.SSM(cfg, _dense(tree["in_proj"], i, device, dtype),
                    _dense(tree["out_proj"], i, device, dtype), device)
    for name in ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm"):
        getattr(p, name).data = _tensor(tree[name][i], device, torch.float32)
    return p


def _block(cfg: ModelConfig, lt: dict, i: int, device, dtype) -> tfm.Block:
    kw = {}
    for key in ("norm1", "norm2", "norm_x"):
        if key in lt:
            kw[key] = _norm(cfg, lt[key], i, device)
    for key in ("attn", "xattn"):
        if key in lt:
            kw[key] = _attention(lt[key], i, device, dtype)
    if "mlp" in lt:
        kw["mlp"] = _mlp(lt["mlp"], i, device, dtype)
    if "moe" in lt:
        kw["moe"] = _moe(lt["moe"], i, device, dtype)
    if "ssm" in lt:
        kw["ssm"] = _ssm(cfg, lt["ssm"], i, device, dtype)
    return tfm.Block(**kw)


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None,
                      dtype: torch.dtype | None = None) -> tfm.Transformer:
    """The reference's parameters (numpy, layers stacked) as the port's
    ``Transformer`` on ``device`` (``None``: the card, see
    ``repro_torch.device.resolve_device``)."""
    device = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    layers = [_block(cfg, tree["layers"], i, device, dtype)
              for i in range(cfg.n_layers)]
    enc_layers = enc_norm = None
    if "enc_layers" in tree:
        enc_layers = [_block(cfg, tree["enc_layers"], i, device, dtype)
                      for i in range(cfg.n_enc_layers)]
        enc_norm = _norm(cfg, tree["enc_norm"], None, device)
    unembed = tree.get("unembed")
    return tfm.Transformer(
        _tensor(tree["embed"], device, dtype), layers,
        _norm(cfg, tree["final_norm"], None, device),
        None if unembed is None else _tensor(unembed, device, dtype),
        enc_layers, enc_norm)


# ---------------------------------------------------------------------------
# The port's modules -> the reference's leaves
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RefLeaf:
    """One leaf of the reference's parameter tree: its key ``path``, the
    port's ``tensors`` it is made of (one per layer, stacked along a new
    leading axis, where ``stacked``; else one) and whether each is a dense
    weight, stored transposed in the port."""

    path: tuple
    tensors: tuple
    stacked: bool
    transpose: bool

    def _part(self, t: torch.Tensor) -> torch.Tensor:
        return t.T if self.transpose else t

    @property
    def shape(self) -> tuple:
        one = tuple(self._part(self.tensors[0]).shape)
        return (len(self.tensors),) + one if self.stacked else one

    @property
    def device(self) -> torch.device:
        return self.tensors[0].device

    def gather(self, pick: Callable = torch.Tensor.detach) -> torch.Tensor:
        """``pick(t)`` of each tensor (the tensor, or its gradient) in the
        reference's layout: stacked and / or transposed (a copy then)."""
        parts = [self._part(pick(t)) for t in self.tensors]
        return torch.stack(parts) if self.stacked else parts[0]

    @torch.no_grad()
    def scatter(self, value: torch.Tensor) -> None:
        """Write ``value`` (the reference's layout) into the port's
        tensors, in place."""
        for i, t in enumerate(self.tensors):
            t.copy_(self._part(value[i] if self.stacked else value))


def reference_leaves(cfg: ModelConfig, model: tfm.Transformer
                     ) -> list[RefLeaf]:
    """The reference tree's leaves, in its flatten order (keys sorted at
    every level), from the port's ``model``: ``layers.<i>.<...>`` and
    ``enc_layers.<i>.<...>`` stacked over i; a ``Dense``'s ``weight`` /
    ``bias`` as the reference's ``w`` (transposed) / ``b``."""
    groups: dict[tuple, list] = {}
    for name, t in model.named_parameters():
        parts = name.split(".")
        owner = model.get_submodule(".".join(parts[:-1]))
        dense = isinstance(owner, Dense)
        leaf = {"weight": "w", "bias": "b"}[parts[-1]] if dense else parts[-1]
        stacked = parts[0] in ("layers", "enc_layers")
        keys = ([parts[0]] + parts[2:-1] if stacked else parts[:-1]) + [leaf]
        layer = int(parts[1]) if stacked else 0
        groups.setdefault(tuple(keys), []).append(
            (layer, t, stacked, dense and parts[-1] == "weight"))
    out = []
    for path in sorted(groups):
        items = sorted(groups[path], key=lambda it: it[0])
        out.append(RefLeaf(path, tuple(it[1] for it in items), items[0][2],
                           items[0][3]))
    return out


def _nest(pairs) -> dict:
    tree: dict = {}
    for path, value in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def params_to_numpy(cfg: ModelConfig, model: tfm.Transformer) -> dict:
    """The port's ``Transformer`` as the reference's numpy tree (layers
    stacked, dense weights ``(d_in, d_out)``, f32): what
    ``params_from_numpy`` reads back."""
    return _nest((leaf.path, _to_numpy(leaf.gather().float()))
                 for leaf in reference_leaves(cfg, model))


def _moment_to_numpy(m):
    if isinstance(m, Quant8):
        return (_to_numpy(m.q), _to_numpy(m.hi))
    return _to_numpy(m)


def train_state_to_numpy(cfg: ModelConfig, state: dict) -> dict:
    """A port train state (``training.step.init_train_state``) as the
    reference's: ``{"params", "opt": {"m", "v", "step"}, "step"}`` with the
    moments in the parameters' tree (a ``Quant8`` as its ``(q, hi)`` pair,
    the reference's two children) and both steps 0-d int32."""
    leaves = reference_leaves(cfg, state["params"])
    opt = state["opt"]
    paths = [leaf.path for leaf in leaves]
    return {
        "params": params_to_numpy(cfg, state["params"]),
        "opt": {"m": _nest(zip(paths, map(_moment_to_numpy, opt["m"]))),
                "v": _nest(zip(paths, map(_moment_to_numpy, opt["v"]))),
                "step": np.asarray(int(opt["step"]), np.int32)},
        "step": np.asarray(int(state["step"]), np.int32),
    }


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def train_state_from_numpy(cfg: ModelConfig, tree: dict, device=None
                           ) -> dict:
    """The reference's train state (numpy, as ``train_state_to_numpy``
    gives it or ``repro.checkpoint.restore`` returns it, ``Quant8`` moments
    as ``(q, hi)`` pairs or objects with ``q`` / ``hi``) as the port's: f32
    parameters that require gradients, and the moments on ``device``."""
    device = resolve_device(device)
    model = params_from_numpy(cfg, tree["params"], device, torch.float32)
    for t in model.parameters():
        t.requires_grad_(True)
    leaves = reference_leaves(cfg, model)

    def moment(m, leaf):
        if isinstance(m, np.ndarray):
            return torch.from_numpy(np.array(m, np.float32)).to(device)
        q, hi = (m.q, m.hi) if hasattr(m, "q") else m
        return Quant8(q=torch.from_numpy(np.array(q, np.int8)).to(device),
                      hi=torch.from_numpy(np.array(hi, np.float32)).to(
                          device), shape=leaf.shape)

    opt = tree["opt"]
    return {
        "params": model,
        "opt": {"m": [moment(_get(opt["m"], l.path), l) for l in leaves],
                "v": [moment(_get(opt["v"], l.path), l) for l in leaves],
                "step": torch.tensor(int(opt["step"]), dtype=torch.int32,
                                     device=device)},
        "step": int(tree["step"]),
    }

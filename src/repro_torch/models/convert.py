"""The weight carrier: the reference's parameter tree -> the port's modules.

``params_from_numpy(cfg, tree, device, dtype)`` takes the tree that
``repro.models.transformer.init_params`` returns, already turned into numpy
arrays by the caller (``jax.tree.map(np.asarray, params)``), with the
layers stacked along a leading axis ``(L, ...)``, and returns the port's
``Transformer``.  Dense weights arrive as ``(d_in, d_out)`` (the reference
computes ``x @ w``) and are stored transposed, in ``common.DENSE_LAYOUT``
``(d_out, d_in)``, in ``dtype`` (default: the config's compute dtype).
Norm scales, the conv kernel and the SSM vectors stay f32, as the
reference keeps and applies them.  This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import Dense, ModelConfig, Norm


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


def _block(cfg: ModelConfig, lt: dict, i: int, device, dtype) -> tfm.Block:
    a, s, m = lt["attn"], lt["ssm"], lt["mlp"]
    ssm_p = ssm_mod.SSM(cfg, _dense(s["in_proj"], i, device, dtype),
                        _dense(s["out_proj"], i, device, dtype), device)
    for name in ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm"):
        getattr(ssm_p, name).data = _tensor(s[name][i], device, torch.float32)
    return tfm.Block(
        _norm(cfg, lt["norm1"], i, device),
        attn.Attention(*(_dense(a[n], i, device, dtype)
                         for n in ("wq", "wk", "wv", "wo"))),
        ssm_p,
        _norm(cfg, lt["norm2"], i, device),
        mlp_mod.MLP(*(_dense(m[n], i, device, dtype)
                      for n in ("wg", "wu", "wd"))))


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None,
                      dtype: torch.dtype | None = None) -> tfm.Transformer:
    """The reference's parameters (numpy, layers stacked) as the port's
    ``Transformer`` on ``device`` (``None``: the card, see
    ``repro_torch.device.resolve_device``)."""
    tfm._require_ported(cfg)
    device = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    layers = [_block(cfg, tree["layers"], i, device, dtype)
              for i in range(cfg.n_layers)]
    unembed = tree.get("unembed")
    return tfm.Transformer(
        _tensor(tree["embed"], device, dtype), layers,
        _norm(cfg, tree["final_norm"], None, device),
        None if unembed is None else _tensor(unembed, device, dtype))

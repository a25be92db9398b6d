"""Parameter partition rules per architecture family.

Counterpart of ``repro/distributed/partition.py``, rule for rule.  The
rules run on the reference's parameter tree: a nested dict of ``(shape,
dtype)`` leaves (``ShapeDtype``) with the layers stacked on a leading
``L`` axis and dense weights ``(d_in, d_out)``.  ``param_shapes`` builds
that tree from the port's model through ``convert.reference_leaves`` (on a
model built on ``meta`` nothing is allocated), and ``port_specs`` maps the
specs back onto the port's own tensors.

  TP   ('model'): q heads / kv proj out-dim / ffn hidden / vocab / experts
  FSDP (rules.fsdp, usually 'data'): the remaining large dim of every
        matrix (ZeRO-3); None -> replicate over data
  layer-stacked leaves get None prepended for the L dim

Optimizer-state specs mirror param specs (same shapes); ``Quant8`` moments
shard their flat-block dims over fsdp only.

Trees here are nested dicts (flattened in sorted key order, as JAX
flattens them), lists and tuples, with ``Quant8`` a node of two children
(``q``, ``hi``); ``tree_map`` / ``tree_leaves`` walk them.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.launch.mesh import (
    PartitionSpec as P, ShapeDtype, is_shape_leaf, local_shape, shape_dtype,
)
from repro_torch.models import convert
from repro_torch.models.common import ModelConfig, ShardRules
from repro_torch.training.optimizer import Quant8


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _is_node(x) -> bool:
    if isinstance(x, (P, str)) or is_shape_leaf(x):
        return False
    return isinstance(x, (dict, list, tuple, Quant8))


def _child(node, part):
    """``node[part]``, where a ``Quant8`` and a checkpoint's ``(q, hi)`` pair
    are one node: ``"q"`` / ``0`` and ``"hi"`` / ``1``."""
    if isinstance(node, Quant8):
        return getattr(node, part) if isinstance(part, str) else \
            (node.q, node.hi)[part]
    if isinstance(node, tuple) and isinstance(part, str):
        return node[("q", "hi").index(part)]
    return node[part]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves (or
    subtrees) of ``rest``, in ``tree``'s structure."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, Quant8):
        return Quant8(q=tree_map(fn, tree.q, *(_child(r, "q") for r in rest),
                                 is_leaf=is_leaf),
                      hi=tree_map(fn, tree.hi,
                                  *(_child(r, "hi") for r in rest),
                                  is_leaf=is_leaf),
                      shape=tree.shape)
    return type(tree)(tree_map(fn, v, *(_child(r, i) for r in rest),
                               is_leaf=is_leaf)
                      for i, v in enumerate(tree))


def tree_leaves_with_path(tree, is_leaf: Callable | None = None,
                          prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """``(key path, leaf)`` in flatten order: dict keys sorted, sequences in
    order, a ``Quant8``'s ``q`` before its ``hi``."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, Quant8):
        items = [("q", tree.q), ("hi", tree.hi)]
    else:
        items = list(enumerate(tree))
    return [pl for k, v in items
            for pl in tree_leaves_with_path(v, is_leaf, prefix + (k,))]


def tree_leaves(tree, is_leaf: Callable | None = None) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree, is_leaf)]


def nest(pairs) -> dict:
    """``(path, value)`` pairs -> a nested dict."""
    tree: dict = {}
    for path, value in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def is_spec(x) -> bool:
    return isinstance(x, P)


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------


def fit_spec(spec: P, shape: tuple, axis_sizes: dict) -> P:
    """Drop sharding on any dim the mesh does not evenly divide.

    A sharded leaf must split exactly (``launch.mesh.device_put`` raises
    otherwise, as jit's in_shardings do), so specs are fitted against the
    actual mesh: e.g. granite-moe's vocab 49155 over tp=16 falls back to
    replicated-vocab, sharded-d_model.
    """
    fitted = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            fitted.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        for a in axes:
            size *= axis_sizes.get(a, 1)
        fitted.append(ax if size and shape[i] % size == 0 else None)
    return P(*fitted)


def fit_tree(specs, sds_tree, axis_sizes: dict):
    """fit_spec over a whole (spec, shape) tree pair."""
    return tree_map(lambda spec, sd: fit_spec(spec, shape_dtype(sd).shape,
                                              axis_sizes),
                    specs, sds_tree, is_leaf=is_spec)


def _spec_for(path: tuple[str, ...], leaf, rules: ShardRules) -> P:
    tp, fs = rules.tp, rules.fsdp
    name = path[-1]
    joined = "/".join(path)
    nd = getattr(leaf, "ndim", 0)

    def stacked(spec: P) -> P:
        """Prepend None for the layer dim when the leaf is stacked."""
        if path[0] in ("layers", "enc_layers") and nd == len(spec) + 1:
            return P(None, *spec)
        return spec

    # embeddings
    if path[0] in ("embed", "unembed"):
        return P(tp, fs)
    # norms, scalars, small per-head params (bias vectors replicate)
    if nd <= 1 or name in ("scale", "b", "conv_b", "a_log", "dt_bias",
                           "d_skip", "norm", "bias"):
        return stacked(P()) if nd else P()
    # attention
    if "attn" in joined or "xattn" in joined:
        if name == "w":
            if path[-2] == "wo":
                return stacked(P(tp, fs))
            return stacked(P(fs, tp))          # wq, wk, wv
    # dense mlp
    if name == "w":
        if path[-2] == "wd":
            return stacked(P(tp, fs))
        if path[-2] in ("wg", "wu", "in_proj"):
            return stacked(P(fs, tp))
        if path[-2] == "out_proj":
            return stacked(P(tp, fs))
        if path[-2] == "router":
            return stacked(P(fs, None))
    # moe expert banks (E, D, F) / (E, F, D): EP over tp
    if name in ("wg", "wu") and nd >= 3:
        return stacked(P(tp, fs, None))
    if name == "wd" and nd >= 3:
        return stacked(P(tp, None, fs))
    # ssm conv (k, C)
    if name == "conv_w":
        return stacked(P(None, tp))
    return stacked(P(*([None] * nd)))


def param_specs(cfg: ModelConfig, params, rules: ShardRules):
    """PartitionSpec tree for a param tree (``param_shapes``' layout)."""
    return nest((tuple(map(str, path)), _spec_for(
        tuple(map(str, path)), shape_dtype(leaf), rules))
        for path, leaf in tree_leaves_with_path(params))


def opt_specs(cfg: ModelConfig, p_specs, opt_sds, rules: ShardRules):
    """Optimizer-state specs: moments mirror params; Quant8 moments shard
    their flat (n_blocks, block) payload over fsdp."""
    def mom(spec, sd):
        if isinstance(sd, Quant8):
            return Quant8(q=P(rules.fsdp, None), hi=P(rules.fsdp, None),
                          shape=sd.shape)
        return spec

    return {
        "m": tree_map(mom, p_specs, opt_sds["m"], is_leaf=is_spec),
        "v": tree_map(mom, p_specs, opt_sds["v"], is_leaf=is_spec),
        "step": P(),
    }


def batch_specs(batch_shapes: dict, rules: ShardRules) -> dict:
    """Batch dims shard over dp; everything else replicated."""
    def spec(sds):
        return P(rules.dp, *([None] * (len(shape_dtype(sds).shape) - 1)))

    return tree_map(spec, batch_shapes)


def serve_state_specs(cfg: ModelConfig, state_shapes: dict,
                      rules: ShardRules, dp_size: int, tp_size: int,
                      kv_len_tp: bool = False) -> dict:
    """Serve-cache specs, divisibility-aware.

    Caches are (L, B, H, cap, dh)-like: batch shards over dp when it
    divides (decode_32k, B=128); at B=1 (long_500k) the cache length
    shards over dp instead (sequence-sharded cache) and heads over tp
    when divisible (mamba2 nh=80 over 16; hymba kv=5 replicates)."""

    def spec(sds):
        shape = shape_dtype(sds).shape
        if len(shape) == 0:
            return P()
        # leading dim is a layer stack -> dims shift by one
        axes: list = [None] * len(shape)
        b_dim = 1
        if shape[b_dim] % dp_size == 0 and shape[b_dim] >= dp_size:
            axes[b_dim] = rules.dp
        else:
            # B too small: shard the longest remaining dim over dp
            cand = max(range(2, len(shape)), key=lambda i: shape[i],
                       default=None) if len(shape) > 2 else None
            if cand is not None and shape[cand] % dp_size == 0:
                axes[cand] = rules.dp
        # heads (dim 2 in kv caches, 5-dim arrays) over tp when divisible
        if rules.tp and len(shape) == 5 and axes[2] is None \
                and shape[2] % tp_size == 0 and shape[2] >= tp_size:
            axes[2] = rules.tp
        # kv_len_tp: shard the cache-length dim over tp (decode variant —
        # attention against the cache becomes a tp-partial softmax)
        if kv_len_tp and rules.tp and len(shape) == 5 and axes[3] is None \
                and rules.tp not in axes and shape[3] % tp_size == 0:
            axes[3] = rules.tp
        return P(*axes)

    return tree_map(spec, state_shapes)


# ---------------------------------------------------------------------------
# The port's model <-> the reference's tree
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig, model) -> dict:
    """The reference's parameter tree of ``model`` as ``ShapeDtype``
    leaves: layers stacked, dense weights ``(d_in, d_out)``, the port's
    dtypes.  Build ``model`` on ``meta`` (``tfm.init_params(cfg,
    common.META, torch.float32)``) to allocate nothing."""
    return nest((leaf.path, ShapeDtype(leaf.shape, leaf.tensors[0].dtype))
                for leaf in convert.reference_leaves(cfg, model))


def opt_shapes(opt_cfg, p_shapes: dict) -> dict:
    """The AdamW state's tree for ``p_shapes`` (``optimizer.init_state``'s
    layout): f32 moments, or ``Quant8`` of ``(n_blocks, block)`` int8
    codes and ``(n_blocks, 1)`` f32 ``hi``; ``step`` int32."""
    def moment(sd):
        if opt_cfg.quantize_state:
            blocks = -(-sd.size // opt_cfg.block)
            return Quant8(q=ShapeDtype((blocks, opt_cfg.block), torch.int8),
                          hi=ShapeDtype((blocks, 1), torch.float32),
                          shape=sd.shape)
        return ShapeDtype(sd.shape, torch.float32)

    return {"m": tree_map(moment, p_shapes), "v": tree_map(moment, p_shapes),
            "step": ShapeDtype((), torch.int32)}


def port_specs(cfg: ModelConfig, model, specs) -> dict[str, P]:
    """Each of ``model``'s parameters (by ``named_parameters`` name) with
    its leaf's spec from ``specs`` (the reference's tree): a stacked
    leaf's leading (layer) entry dropped, and the two entries of a dense
    weight swapped, since the port stores it ``(d_out, d_in)``."""
    names = {id(t): n for n, t in model.named_parameters()}
    out = {}
    for leaf in convert.reference_leaves(cfg, model):
        spec = specs
        for key in leaf.path:
            spec = spec[key]
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        if leaf.stacked:
            entries = entries[1:]
        if leaf.transpose:
            entries = [entries[1], entries[0]] + entries[2:]
        while entries and entries[-1] is None:
            entries.pop()
        for t in leaf.tensors:
            out[names[id(t)]] = P(*entries)
    return out


def spec_bytes(sd, spec, axis_sizes: dict) -> int:
    """Bytes of one device's shard of ``sd`` under ``spec``."""
    sd = shape_dtype(sd)
    return math.prod(local_shape(sd.shape, spec, axis_sizes)) * \
        sd.dtype.itemsize

"""Step builders + sharding spec trees for the dry run and the launchers.

Counterpart of ``repro/launch/steps.py``.  For each cell (arch x shape)
``build_cell`` produces:

  fn            the step (train_step / prefill / decode_step)
  args_sds      ``ShapeDtype`` tree of its inputs, in the reference's layout
                (the parameter tree stacked, dense weights ``(d_in, d_out)``)
  in_specs      PartitionSpec tree matching args_sds, fitted to the mesh
  kind, cfg, rules
  trace_args    builds ``fn``'s own arguments on ``meta`` (the port's model,
                its optimizer state, the batch / serve state): nothing is
                allocated, so the dry run can trace a cell of any size

Parameters are made on ``meta``.  Serving casts the reference's f32 leaves
of two or more dims to the compute dtype, or to int8 with ``wq=int8``, as
the reference's does (its stacked norm scales are such leaves too).

Variants (the hillclimb knobs) are config / rule transformations applied
before building: remat policy, fsdp on/off, 8-bit optimizer, int8 weights
for decode, scan-attention block size, MoE capacity, ...
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import configs
from repro_torch.configs import base as cfg_base
from repro_torch.distributed import partition
from repro_torch.launch.mesh import P, ShapeDtype, dp_axes, shape_dtype
from repro_torch.models import convert
from repro_torch.models import transformer as tfm
from repro_torch.models.common import META, ModelConfig, ShardRules
from repro_torch.serving import engine
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import step as step_mod


def apply_variant(cfg: ModelConfig, rules: ShardRules, opt_cfg,
                  variant: str):
    """Parse 'k=v,k=v' variant strings into config/rule overrides."""
    quant_weights = False
    extras = {"castbf16": False, "kvtp": False}
    for item in filter(None, (variant or "").split(",")):
        k, _, v = item.partition("=")
        if k == "remat":
            cfg = dataclasses.replace(cfg, remat=v)
        elif k == "fsdp":
            rules = dataclasses.replace(
                rules, fsdp=None if v in ("none", "off") else v)
        elif k == "sp":
            rules = dataclasses.replace(
                rules, sp=None if v in ("none", "off") else v)
        elif k == "opt8":
            opt_cfg = dataclasses.replace(opt_cfg, quantize_state=v == "on")
        elif k == "attn_block":
            cfg = dataclasses.replace(cfg, attn_block=int(v))
        elif k == "cap":
            cfg = dataclasses.replace(cfg, capacity_factor=float(v))
        elif k == "wq":
            quant_weights = v == "int8"
        elif k == "dtype":
            cfg = dataclasses.replace(cfg, dtype=v)
        elif k == "castbf16":
            extras["castbf16"] = v == "on"
        elif k == "kvtp":
            extras["kvtp"] = v == "on"
        elif k == "moegroups":
            cfg = dataclasses.replace(cfg, moe_groups=int(v))
        elif k == "moe2d":
            cfg = dataclasses.replace(cfg, moe_two_d=v == "on")
        elif k == "kv":
            cfg = dataclasses.replace(cfg, kv_dtype=v)
        elif k == "unroll":
            cfg = dataclasses.replace(cfg, scan_unroll=v == "on")
        elif k == "scan_attn":
            cfg = dataclasses.replace(cfg, use_scan_attention=v == "on")
        else:
            raise ValueError(f"unknown variant key {k!r}")
    return cfg, rules, opt_cfg, quant_weights, extras


def axis_sizes_of(multi_pod: bool) -> dict:
    """The production mesh's axis sizes."""
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def _shapes(tree):
    return partition.tree_map(shape_dtype, tree)


def _serve_dtype(sd: ShapeDtype, cfg: ModelConfig, quant_w: bool):
    """The reference's serving cast of one leaf: f32 leaves of two or more
    dims to the compute dtype (int8 with ``wq=int8``)."""
    if sd.dtype == torch.float32 and len(sd.shape) >= 2:
        return torch.int8 if quant_w else cfg.compute_dtype
    return sd.dtype


def _meta(tree):
    """A ``ShapeDtype`` tree as meta tensors."""
    return partition.tree_map(
        lambda sd: torch.empty(sd.shape, dtype=sd.dtype, device="meta"),
        tree)


def _serve_model(cfg: ModelConfig, quant_w: bool) -> tfm.Transformer:
    model = tfm.init_params(cfg, META, torch.float32)
    for leaf in convert.reference_leaves(cfg, model):
        dtype = _serve_dtype(ShapeDtype(leaf.shape, leaf.tensors[0].dtype),
                             cfg, quant_w)
        for t in leaf.tensors:
            t.data = torch.empty(t.shape, dtype=dtype, device="meta")
    return model


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               variant: str = "", *, reduced: bool = False):
    """Returns dict(fn, args_sds, in_specs, kind, cfg, rules, trace_args);
    ``reduced`` builds the arch's tiny same-family config instead."""
    mod = configs.get(arch)
    cfg = mod.reduced() if reduced else mod.make_config()
    rules = ShardRules(dp=dp_axes(multi_pod))
    opt_cfg = opt_mod.AdamWConfig()
    cfg, rules, opt_cfg, quant_w, extras = apply_variant(
        cfg, rules, opt_cfg, variant)

    sh = cfg_base.SHAPES[shape_name]
    kind = sh["kind"]
    specs_in = _shapes(cfg_base.input_specs(cfg, shape_name))
    axis_sizes = axis_sizes_of(multi_pod)

    # parameter skeleton on meta (no allocation)
    params_sds = partition.param_shapes(
        cfg, tfm.init_params(cfg, META, torch.float32))
    p_specs = partition.fit_tree(
        partition.param_specs(cfg, params_sds, rules), params_sds, axis_sizes)

    if kind == "train":
        opt_sds = partition.opt_shapes(opt_cfg, params_sds)
        state_sds = {"params": params_sds, "opt": opt_sds,
                     "step": ShapeDtype((), torch.int32)}
        state_specs = {
            "params": p_specs,
            "opt": partition.fit_tree(
                partition.opt_specs(cfg, p_specs, opt_sds, rules),
                opt_sds, axis_sizes),
            "step": P(),
        }
        batch_sds = specs_in["batch"]
        batch_specs = partition.fit_tree(
            partition.batch_specs(batch_sds, rules), batch_sds, axis_sizes)
        fn = step_mod.make_train_step(
            cfg, rules, opt_cfg, cast_params_bf16=extras["castbf16"])

        def trace_args():
            state = step_mod.init_train_state(cfg, opt_cfg, META)
            return state, _meta(batch_sds)

        return dict(fn=fn, args_sds=(state_sds, batch_sds),
                    in_specs=(state_specs, batch_specs), kind=kind,
                    cfg=cfg, rules=rules, trace_args=trace_args)

    serve_params_sds = partition.tree_map(
        lambda sd: ShapeDtype(sd.shape, _serve_dtype(sd, cfg, quant_w)),
        params_sds)

    if kind == "prefill":
        batch_sds = specs_in["batch"]
        batch_specs = partition.fit_tree(
            partition.batch_specs(batch_sds, rules), batch_sds, axis_sizes)
        cap = sh["seq_len"] + (cfg.n_patches if cfg.family == "vlm" else 0)

        if cfg.family == "audio":
            def fn(params, batch):
                return engine.prefill_audio(cfg, params, batch, cap, rules)
        else:
            def fn(params, batch):
                return engine.prefill(cfg, params, batch, cap, rules)

        def trace_args():
            return _serve_model(cfg, quant_w), _meta(batch_sds)

        return dict(fn=fn, args_sds=(serve_params_sds, batch_sds),
                    in_specs=(p_specs, batch_specs), kind=kind,
                    cfg=cfg, rules=rules, trace_args=trace_args)

    # decode
    state_sds = specs_in["state"]
    tok_sds = specs_in["tokens"]
    dp_size = 32 if multi_pod else 16
    st_specs = partition.fit_tree(
        partition.serve_state_specs(cfg, state_sds, rules,
                                    dp_size=dp_size, tp_size=16,
                                    kv_len_tp=extras["kvtp"]),
        state_sds, axis_sizes)
    b = tok_sds.shape[0]
    tok_spec = P(rules.dp, None) if b % dp_size == 0 else P(None, None)

    def fn(params, state, tokens):
        return engine.decode_step(cfg, params, state, tokens, rules)

    def trace_args():
        state = engine.init_state(cfg, b, sh["seq_len"], "meta")
        state["pos"] = sh["seq_len"] - 1
        if "enc_len" in state:
            state["enc_len"] = state["xk"].shape[3]
        return _serve_model(cfg, quant_w), state, _meta(tok_sds)

    return dict(fn=fn, args_sds=(serve_params_sds, state_sds, tok_sds),
                in_specs=(p_specs, st_specs, tok_spec), kind=kind,
                cfg=cfg, rules=rules, trace_args=trace_args)

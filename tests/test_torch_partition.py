"""The port's partition rules (``distributed/partition.py``) against the
reference's, on the CPU.

* every case of tests/test_distributed.py's spec logic (``fit_spec``,
  every large leaf of five configs sharded);
* ``param_specs``, ``opt_specs`` (f32 and ``Quant8`` moments) and
  ``fit_tree`` equal the reference's leaf for leaf, for all ten configs
  under ``ShardRules()``, ``fsdp=None`` and multi-pod dp, at the
  production axis sizes: the reference's shapes from ``jax.eval_shape``,
  the port's from its model built on ``meta``;
* ``batch_specs`` and ``serve_state_specs`` (``kv_len_tp`` off and on)
  equal the reference's for every cell of ``configs.shapes_for``;
* ``port_specs`` puts each spec on the port's own tensors: dense weights
  transposed, the stacked layer axis dropped, MoE banks as they are.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro import configs as r_configs
from repro.configs import base as r_base
from repro.distributed import partition as r_part
from repro.models import transformer as r_tfm
from repro.models.common import ShardRules as RRules
from repro.training import optimizer as r_opt
from repro_torch import configs
from repro_torch.configs import base as cfg_base
from repro_torch.distributed import partition
from repro_torch.launch.mesh import P, shape_dtype
from repro_torch.models import transformer as tfm
from repro_torch.models.common import META, ShardRules
from repro_torch.training import optimizer as opt_mod

SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}
RULE_SETS = {
    "default": (dict(), SINGLE),
    "fsdp_none": (dict(fsdp=None), SINGLE),
    "multi_pod": (dict(dp=("pod", "data")), MULTI),
}


def _norm(spec) -> tuple:
    """A spec's entries with one-name tuples as the name (as jax compares
    them)."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple):
            e = e[0] if len(e) == 1 else tuple(e)
        out.append(e)
    return tuple(out)


def _r_leaves(tree):
    return [_norm(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, RP))]


def _leaves(tree):
    return [_norm(s) for s in partition.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _r_shapes(arch):
    cfg = r_configs.get(arch).make_config()
    return cfg, jax.eval_shape(lambda: r_tfm.init_params(
        cfg, jax.random.PRNGKey(0)))


def _shapes(arch):
    cfg = configs.get(arch).make_config()
    return cfg, partition.param_shapes(
        cfg, tfm.init_params(cfg, META, torch.float32))


# -- tests/test_distributed.py's cases ---------------------------------------


def test_fit_spec_divisibility():
    sizes = {"data": 16, "model": 16}
    assert partition.fit_spec(P("model", "data"), (49155, 1024), sizes) \
        == P(None, "data")
    assert partition.fit_spec(P("model", "data"), (49152, 1024), sizes) \
        == P("model", "data")
    assert partition.fit_spec(P(("pod", "data"), None), (64, 7),
                              {"pod": 2, "data": 16, "model": 16}) \
        == P(("pod", "data"), None)
    assert partition.fit_spec(P(("pod", "data"),), (31,),
                              {"pod": 2, "data": 16}) == P(None)
    assert P("model", "data") == ("model", "data")
    assert P(("data",), None) == P("data", None)


def test_param_specs_cover_every_leaf():
    for arch in ("qwen2.5-32b", "kimi-k2-1t-a32b", "mamba2-2.7b",
                 "whisper-medium", "hymba-1.5b"):
        cfg, sds = _shapes(arch)
        specs = partition.param_specs(cfg, sds, ShardRules())
        flat_sds = partition.tree_leaves(sds)
        flat_sp = partition.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, P))
        assert len(flat_sds) == len(flat_sp)
        for sd, sp in zip(flat_sds, flat_sp):
            if np.prod(sd.shape) > 4e6:
                assert any(a is not None for a in sp), (arch, sd.shape, sp)


# -- every config's parameter and optimizer specs ------------------------------


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_and_opt_specs_equal_the_reference(arch):
    r_cfg, r_sds = _r_shapes(arch)
    cfg, sds = _shapes(arch)
    r_flat, flat = jax.tree.leaves(r_sds), partition.tree_leaves(sds)
    assert [tuple(x.shape) for x in r_flat] == [x.shape for x in flat]
    r_q8 = jax.eval_shape(lambda: r_opt.init_state(
        r_opt.AdamWConfig(quantize_state=True), r_sds))
    q8 = partition.opt_shapes(opt_mod.AdamWConfig(quantize_state=True), sds)
    assert [tuple(x.shape) for x in jax.tree.leaves(r_q8)] == \
        [x.shape for x in partition.tree_leaves(q8)]
    r_f32 = jax.eval_shape(lambda: r_opt.init_state(r_opt.AdamWConfig(),
                                                    r_sds))
    f32 = partition.opt_shapes(opt_mod.AdamWConfig(), sds)
    for name, (kw, sizes) in RULE_SETS.items():
        r_rules, rules = RRules(**kw), ShardRules(**kw)
        r_ps = r_part.param_specs(r_cfg, r_sds, r_rules)
        ps = partition.param_specs(cfg, sds, rules)
        assert _leaves(ps) == _r_leaves(r_ps), name
        r_fit = r_part.fit_tree(r_ps, r_sds, sizes)
        fit = partition.fit_tree(ps, sds, sizes)
        assert _leaves(fit) == _r_leaves(r_fit), name
        for r_o, o in ((r_q8, q8), (r_f32, f32)):
            r_os = r_part.fit_tree(r_part.opt_specs(r_cfg, r_fit, r_o,
                                                    r_rules), r_o, sizes)
            os_ = partition.fit_tree(partition.opt_specs(cfg, fit, o, rules),
                                     o, sizes)
            assert _leaves(os_) == _r_leaves(r_os), name


# -- batch and serve-state specs, every cell -----------------------------------


def _cells():
    return [(a, s) for a in configs.ARCHS for s in configs.shapes_for(a)]


@pytest.mark.parametrize("arch,shape", _cells())
def test_batch_and_serve_state_specs_equal_the_reference(arch, shape):
    r_cfg = r_configs.get(arch).make_config()
    cfg = configs.get(arch).make_config()
    r_in = r_base.input_specs(r_cfg, shape)
    got_in = cfg_base.input_specs(cfg, shape)
    for kw, sizes in RULE_SETS.values():
        r_rules, rules = RRules(**kw), ShardRules(**kw)
        if "batch" in r_in:
            r_b = r_part.fit_tree(r_part.batch_specs(r_in["batch"], r_rules),
                                  r_in["batch"], sizes)
            b = partition.fit_tree(partition.batch_specs(got_in["batch"],
                                                         rules),
                                   got_in["batch"], sizes)
            assert set(b) == set(r_b)
            for k in r_b:
                assert _norm(b[k]) == _norm(r_b[k]), k
            continue
        dp = sizes["data"] * sizes.get("pod", 1)
        for kvtp in (False, True):
            r_st = r_part.serve_state_specs(r_cfg, r_in["state"], r_rules,
                                            dp, 16, kv_len_tp=kvtp)
            st = partition.serve_state_specs(cfg, got_in["state"], rules,
                                             dp, 16, kv_len_tp=kvtp)
            for k, sd in r_in["state"].items():
                assert shape_dtype(got_in["state"][k]).shape == \
                    tuple(sd.shape), k
                assert _norm(st[k]) == _norm(r_st[k]), (k, kvtp)


# -- the specs on the port's own tensors ---------------------------------------


def test_port_specs_transpose_dense_and_drop_the_layer_axis():
    cfg = dataclasses.replace(configs.get("granite-moe-1b-a400m").reduced(),
                              n_shared_experts=1)
    model = tfm.init_params(cfg, META, torch.float32)
    sds = partition.param_shapes(cfg, model)
    specs = partition.param_specs(cfg, sds, ShardRules())
    assert specs["layers"]["attn"]["wq"]["w"] == P(None, "data", "model")
    assert specs["layers"]["moe"]["wd"] == P(None, "model", None, "data")
    got = partition.port_specs(cfg, model, specs)
    assert got["layers.0.attn.wq.weight"] == P("model", "data")
    assert got["layers.1.attn.wo.weight"] == P("data", "model")
    assert got["layers.0.moe.wg"] == P("model", "data")
    assert got["layers.0.moe.wd"] == P("model", None, "data")
    assert got["layers.0.moe.router.weight"] == P(None, "data")
    assert got["layers.0.moe.shared.wd.weight"] == P("data", "model")
    assert got["layers.0.norm1.scale"] == P()
    assert got["embed"] == P("model", "data")
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, t in model.named_parameters():
        assert len(got[name]) <= t.ndim, name

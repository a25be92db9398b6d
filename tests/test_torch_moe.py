"""The port's sort-based capacity MoE against the JAX reference, on the CPU.

The reference's ``reduced()`` granite-moe (8 experts, top-2, d_ff 64, f32)
and kimi-k2 (with a shared expert) with the reference's own initial
parameters, carried into the port by ``convert.params_from_numpy``; the
same numpy activations go to both.  The top-k indices must be equal, then
the outputs within atol / rtol 1e-5 (the same products in another order)
and the aux loss within rtol 1e-5.  Capacity routing keeps and drops the
same assignments as the reference: its capacity formula, stable sort and
sentinel slots, checked where the capacity drops assignments.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import mlp as r_mlp
from repro.models import transformer as r_tfm
from repro.models.common import ShardRules
from repro_torch import configs
from repro_torch.models import mlp
from repro_torch.models.convert import params_from_numpy

RULES = ShardRules()
TIGHT = dict(atol=1e-5, rtol=1e-5)

# The reference's functions jitted with their config and rules static: one
# compile per case in place of an eager dispatch per op.
R_INIT = jax.jit(r_tfm.init_params, static_argnums=0)
R_MOE = jax.jit(r_mlp.apply_moe, static_argnums=(0, 1))

_MODELS: dict = {}


def _moe(arch, **over):
    """(cfg, reference cfg, reference layer-0 moe params, port MoE)."""
    if arch not in _MODELS:
        cfg = configs.get(arch).reduced()
        r_cfg = r_configs.get(arch).reduced()
        params = R_INIT(r_cfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, params)
        port = params_from_numpy(cfg, tree, "cpu")
        lp = jax.tree.map(lambda a: a[0], params["layers"])["moe"]
        _MODELS[arch] = (cfg, r_cfg, lp, port.layers[0].moe, tree)
    cfg, r_cfg, lp, p, _ = _MODELS[arch]
    return (dataclasses.replace(cfg, **over),
            dataclasses.replace(r_cfg, **over), lp, p)


def _x(cfg, b=2, s=32, seed=0):
    return np.random.RandomState(seed).randn(b, s, cfg.d_model).astype(
        np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _run(cfg, r_cfg, lp, p, x):
    y_r, a_r = R_MOE(r_cfg, RULES, lp, jnp.asarray(x))
    y, a = mlp.apply_moe(cfg, p, torch.as_tensor(x))
    return y, a, y_r, a_r


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
def test_router_top_k_equal_reference(arch):
    cfg, r_cfg, lp, p = _moe(arch)
    x = _x(cfg).reshape(-1, cfg.d_model)
    logits = np.asarray(x) @ np.asarray(lp["router"]["w"])
    probs_r = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    _, idx_r = jax.lax.top_k(probs_r, cfg.top_k)
    top_p, top_i, _ = mlp._route(cfg, p, torch.as_tensor(x))
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(idx_r))
    np.testing.assert_allclose(top_p.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 4.0])
def test_apply_moe_matches_reference(arch, capacity_factor):
    """At the config's factor, at one that drops about half of the
    assignments (the same ones must drop) and at one that drops none."""
    cfg, r_cfg, lp, p = _moe(arch, capacity_factor=capacity_factor)
    y, a, y_r, a_r = _run(cfg, r_cfg, lp, p, _x(cfg, seed=1))
    np.testing.assert_allclose(_np(y), _np(y_r), **TIGHT)
    np.testing.assert_allclose(float(a), float(a_r), rtol=1e-5)


@pytest.mark.parametrize("t", [1, 2, 3, 4, 7, 8, 9, 31, 64, 200])
@pytest.mark.parametrize("two_d", [False, True])
def test_capacity_matches_reference_formula(t, two_d):
    """The decode floor (tiny t), Python's round half to even and the
    moe_two_d rounding: ``capacity`` against the reference's expression
    (``repro/models/mlp.py``, ``apply_moe``), restated here; the dispatch
    tests above hold the slots it gives to the reference's outputs."""
    cfg, r_cfg, lp, p = _moe("granite-moe-1b-a400m", moe_two_d=two_d)
    cap = mlp.capacity(cfg, t, two_d)
    want = int(max(1, round(t * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)))
    want = max(want, min(t, 2 * cfg.top_k))
    if two_d:
        want = -(-want // 128) * 128
    assert cap == want


@pytest.mark.parametrize("s", [1, 3])
def test_decode_sized_moe_matches_reference(s):
    """B = 2 tokens at a time, as decode routes them (the decode floor
    sets the capacity), and a 3-token step."""
    cfg, r_cfg, lp, p = _moe("granite-moe-1b-a400m")
    y, _, y_r, _ = _run(cfg, r_cfg, lp, p, _x(cfg, s=s, seed=2))
    np.testing.assert_allclose(_np(y), _np(y_r), **TIGHT)


def test_two_d_rounding_matches_reference():
    cfg, r_cfg, lp, p = _moe("granite-moe-1b-a400m", moe_two_d=True)
    y, _, y_r, _ = _run(cfg, r_cfg, lp, p, _x(cfg, seed=3))
    np.testing.assert_allclose(_np(y), _np(y_r), **TIGHT)


@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_moe_matches_reference(groups):
    """moe_groups > 1 goes to the grouped dispatch, in both packages."""
    cfg, r_cfg, lp, p = _moe("granite-moe-1b-a400m", moe_groups=groups)
    y, a, y_r, a_r = _run(cfg, r_cfg, lp, p, _x(cfg, seed=4))
    np.testing.assert_allclose(_np(y), _np(y_r), **TIGHT)
    np.testing.assert_allclose(float(a), float(a_r), rtol=1e-5)


def test_grouped_moe_equals_flat_when_no_drops():
    """As tests/test_models_smoke.py checks the reference: with capacity
    for every token the grouped dispatch is a re-layout of the flat one."""
    cfg, _, _, p = _moe("granite-moe-1b-a400m", capacity_factor=4.0)
    x = torch.as_tensor(_x(cfg))
    y1, a1 = mlp.apply_moe(cfg, p, x)
    y2, a2 = mlp.apply_moe(dataclasses.replace(cfg, moe_groups=4), p, x)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-6)
    np.testing.assert_allclose(float(a1), float(a2), atol=1e-7)


def test_grouped_moe_refuses_uneven_groups():
    cfg, _, _, p = _moe("granite-moe-1b-a400m", moe_groups=3)
    with pytest.raises(ValueError, match="groups"):
        mlp.apply_moe(cfg, p, torch.as_tensor(_x(cfg, s=4)))


def test_bf16_moe_matches_reference():
    """bf16 activations: the router still routes in f32 (same top-k as the
    reference's), the experts run in bf16; outputs within 2e-2."""
    cfg, r_cfg, lp, _ = _moe("kimi-k2-1t-a32b", dtype="bfloat16")
    tree = _MODELS["kimi-k2-1t-a32b"][4]
    p = params_from_numpy(cfg, tree, "cpu").layers[0].moe
    assert p.router.weight.dtype == torch.float32
    x = _x(cfg, seed=5)
    y_r, _ = R_MOE(r_cfg, RULES, lp, jnp.asarray(x, jnp.bfloat16))
    y, _ = mlp.apply_moe(cfg, p, torch.as_tensor(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), _np(y_r), atol=2e-2, rtol=2e-2)

"""The port's mixed-precision domains (``core/mixed_precision.py``) against
the reference's, on the CPU.

``QuantTensor``'s int8 codes and f32 scales equal the reference's bit for
bit (per last-dim channel and along axis 0), and so do its dequantized
values; ``assign_domains`` and ``tree_param_bytes`` equal the reference's
on tests/test_system.py's toy; ``quantize_tree_where`` routes a tree by
its key paths as the reference's does, and the port's model by the
reference's leaf paths, with each layer's codes the reference's codes of
that layer of the stacked leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixed_precision as r_mp
from repro.models import transformer as r_tfm
from repro_torch import configs
from repro_torch.core import mixed_precision as mp
from repro_torch.models import convert


@pytest.mark.parametrize("shape,axis", [((64, 32), -1), ((3, 16, 8), -1),
                                        ((64, 32), 0)])
def test_quant_tensor_equals_the_reference(shape, axis):
    rng = np.random.RandomState(len(shape) + axis)
    w = (rng.randn(*shape) * 0.05).astype(np.float32)
    w[0] = 0.0                           # an all-zero channel: the 1e-8 floor
    r_q = r_mp.QuantTensor.quantize(jnp.asarray(w), axis=axis)
    q = mp.QuantTensor.quantize(torch.as_tensor(w), axis=axis)
    np.testing.assert_array_equal(q.q.numpy(), np.asarray(r_q.q))
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(r_q.scale))
    assert q.q.dtype == torch.int8 and q.scale.dtype == torch.float32
    np.testing.assert_array_equal(
        q.dequantize(torch.float32).numpy(),
        np.asarray(r_q.dequantize(jnp.float32)))
    assert q.nbytes == r_q.nbytes
    x = np.random.RandomState(9).randn(5, shape[-2] if len(shape) > 1
                                       else 1).astype(np.float32)
    if len(shape) == 2:
        np.testing.assert_allclose(
            mp.dequant_matmul(torch.as_tensor(x), q).numpy(),
            np.asarray(r_mp.dequant_matmul(jnp.asarray(x), r_q)),
            rtol=1e-6, atol=1e-6)


def test_quant_tensor_roundtrip():
    rng = np.random.RandomState(0)
    w = torch.as_tensor(rng.randn(64, 32), dtype=torch.float32)
    q = mp.QuantTensor.quantize(w)
    back = q.dequantize(torch.float32)
    assert float((back - w).abs().max()) < float(w.abs().max()) / 100
    assert q.nbytes < w.numel() * 4 / 3.5


def _quality(domains):
    return 1.0 - (0.1 if domains["m2"] == "cheap" else 0.0)


def test_assign_domains_equals_the_reference():
    modules = ["m1", "m2", "m3"]
    for tol in (0.01, 0.2):
        r_a = r_mp.assign_domains(modules, _quality, tolerance=tol)
        a = mp.assign_domains(modules, _quality, tolerance=tol)
        assert (a.domain, a.quality_cheap, a.quality_exact, a.n_cheap) == (
            r_a.domain, r_a.quality_cheap, r_a.quality_exact, r_a.n_cheap)
    assert mp.assign_domains(modules, _quality, 0.01).domain == {
        "m1": "cheap", "m2": "exact", "m3": "cheap"}


def _route(path):
    return "exact" if path[0] in ("embed", "norm") else "cheap"


def test_quantize_tree_where_and_bytes_equal_the_reference():
    rng = np.random.RandomState(1)
    tree = {"embed": rng.randn(50, 16), "mlp": {"w": rng.randn(16, 24),
                                                "b": rng.randn(24)},
            "norm": {"scale": rng.randn(16)}, "layers": [rng.randn(2, 8, 8)]}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    r_out = r_mp.quantize_tree_where(jax.tree.map(jnp.asarray, tree), _route)
    out = mp.quantize_tree_where(jax.tree.map(torch.as_tensor, tree), _route)
    assert isinstance(out["mlp"]["w"], mp.QuantTensor)
    assert isinstance(out["layers"][0], mp.QuantTensor)
    assert isinstance(out["embed"], torch.Tensor)
    np.testing.assert_array_equal(out["mlp"]["w"].q.numpy(),
                                  np.asarray(r_out["mlp"]["w"].q))
    np.testing.assert_array_equal(out["layers"][0].scale.numpy(),
                                  np.asarray(r_out["layers"][0].scale))
    assert mp.tree_param_bytes(out) == r_mp.tree_param_bytes(r_out)
    assert mp.tree_param_bytes(jax.tree.map(torch.as_tensor, tree)) == \
        r_mp.tree_param_bytes(jax.tree.map(jnp.asarray, tree))


def test_quantize_the_ports_model_by_the_references_paths():
    from repro.configs import get as r_get
    arch = "granite-moe-1b-a400m"
    cfg, r_cfg = configs.get(arch).reduced(), r_get(arch).reduced()
    r_params = jax.jit(r_tfm.init_params, static_argnums=0)(
        r_cfg, jax.random.PRNGKey(0))
    model = convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, r_params), "cpu", torch.float32)

    def route(path):
        return "cheap" if path[0] == "layers" and "moe" in path else "exact"

    r_out = r_mp.quantize_tree_where(r_params, route)
    out = mp.quantize_tree_where(model, route)
    assert set(out) == {n for n, _ in model.named_parameters()}
    cheap = [n for n, v in out.items() if isinstance(v, mp.QuantTensor)]
    assert sorted(cheap) == sorted(
        f"layers.{i}.moe.{k}" for i in range(cfg.n_layers)
        for k in ("wg", "wu", "wd", "router.weight"))
    for i in range(cfg.n_layers):
        for k in ("wg", "wd"):
            np.testing.assert_array_equal(
                out[f"layers.{i}.moe.{k}"].q.numpy(),
                np.asarray(r_out["layers"]["moe"][k].q)[i])
        # the router is stored transposed: quantized in the reference's
        # (d_in, d_out) orientation, its codes are the reference's
        np.testing.assert_array_equal(
            out[f"layers.{i}.moe.router.weight"].q.numpy(),
            np.asarray(r_out["layers"]["moe"]["router"]["w"].q)[i])
    assert mp.tree_param_bytes(out) == r_mp.tree_param_bytes(r_out)

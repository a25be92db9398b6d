"""The port's distribution substrate against the reference's, on the CPU.

One jax subprocess with 8 fake CPU devices (tests/test_distributed.py's
pattern) runs the reference's pipeline case, its elastic roundtrip and
its reduced granite-moe train cell on a (2, 4) mesh (XLA's
``argument_size_in_bytes`` and the losses of two steps, at grad_accum 1
as tests/test_distributed.py runs it and at grad_accum 2), and saves them
to an ``.npz`` that a module-scoped fixture reads.  Against it:

* ``pipeline_forward`` equals the reference's within atol 1e-5, and runs
  the port's own hymba blocks as stages equal to the plain stack;
* ``elastic.reshard`` lays leaves out as the reference's ``device_put``
  does (the same shard at every mesh position) and roundtrips a train
  state restored by the port's ``checkpoint`` from (2, 2) to (4, 1);
* the dry run's ``argument_bytes`` for the train cell equals XLA's
  ``argument_size_in_bytes``;
* the mesh train step on a (2, 4) CPU mesh equals the unsharded step at
  ``grad_accum=2`` bit for bit (f32 and 8-bit moments), and its losses
  over two steps equal the reference's sharded step at grad_accum 2
  within tests/test_torch_training.py's 1e-5 relative.  A dp share is a
  microbatch (its MoE capacity and aux loss are the share's), so the
  reference's grad_accum 2 is its twin; the reference's grad_accum 1
  routes all 128 tokens at once, and its loss is logged beside;
* compression: ``quantize_block`` / ``compress_with_feedback`` codes and
  scales equal the reference's bit for bit; the all-reduce's mean is
  within 1 f32 ulp of the reference's ``compressed_psum_fn("data", 64)``
  run in process (eager) under ``jax.vmap(axis_name="data")`` on the
  reference test's inputs, its error buffers bit for bit, and the
  20-repeat error
  feedback halves the error;
* the 1-D consumers refuse a multi-axis mesh, naming their axis.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as r_comp
from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch.distributed import compression, elastic, partition, pipeline
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import P, ShapeDtype
from repro_torch.models import convert
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ShardRules
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import step as step_mod

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, numpy as np, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro import configs
from repro.distributed import elastic, partition
from repro.distributed.pipeline import pipeline_forward
from repro.models.common import ShardRules
from repro.training import optimizer as opt_mod, step as step_mod

out = {}
auto = lambda n: dict(axis_types=(AxisType.Auto,) * n)

# tests/test_distributed.py::test_pipeline_matches_sequential's case
mesh = jax.make_mesh((8,), ("stage",), **auto(1))
rng = np.random.RandomState(0)
ws = jnp.asarray(rng.randn(8, 16, 16) * 0.3, jnp.float32)
mbs = jnp.asarray(rng.randn(4, 2, 16), jnp.float32)
f = pipeline_forward(mesh, lambda p, x: jnp.tanh(x @ p["w"]), "stage")
out["pipe_out"] = np.asarray(f({"w": ws}, mbs))

# ... ::test_elastic_reshard_roundtrip's
m1 = jax.make_mesh((4, 2), ("data", "model"), **auto(2))
m2 = jax.make_mesh((2, 4), ("data", "model"), **auto(2))
rng = np.random.RandomState(0)
tree = {"w": jnp.asarray(rng.randn(16, 8), jnp.float32),
        "b": jnp.asarray(rng.randn(8), jnp.float32)}
specs = {"w": P("data", "model"), "b": P(None)}
on1 = elastic.reshard(tree, specs, m1)
on2 = elastic.rescale_checkpoint(jax.tree.map(np.asarray, on1), specs, m2)
out["elastic_w"] = np.asarray(on2["w"])
for name, m, arr in (("m1", m1, on1["w"]), ("m2", m2, on2["w"])):
    idx = arr.sharding.devices_indices_map(arr.shape)
    out["elastic_index_" + name] = np.array(
        [[(s.start or 0, s.stop or n) for s, n in zip(idx[d], arr.shape)]
         for d in m.devices.flat])

# ... ::test_small_mesh_train_step_shards's cell
mesh = jax.make_mesh((2, 4), ("data", "model"), **auto(2))
cfg = configs.get("granite-moe-1b-a400m").reduced()
cfg = dataclasses.replace(cfg, d_model=64, d_ff=32, vocab_size=512,
                          n_heads=4, n_kv_heads=2)
rules = ShardRules()
oc = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
state0 = step_mod.init_train_state(cfg, oc, jax.random.PRNGKey(0))
sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state0)
sizes = {"data": 2, "model": 4}
p_specs = partition.fit_tree(
    partition.param_specs(cfg, sds["params"], rules), sds["params"], sizes)
st_specs = {"params": p_specs,
            "opt": partition.fit_tree(
                partition.opt_specs(cfg, p_specs, sds["opt"], rules),
                sds["opt"], sizes),
            "step": P()}
rngn = np.random.RandomState(0)
batch = {"tokens": jnp.asarray(rngn.randint(0, 512, (8, 16))),
         "labels": jnp.asarray(rngn.randint(0, 512, (8, 16)))}
b_specs = {"tokens": P(("data",), None), "labels": P(("data",), None)}
sh = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                            is_leaf=lambda x: isinstance(x, P))
for path, leaf in jax.tree_util.tree_flatten_with_path(state0)[0]:
    key = "/".join(str(getattr(p, "key", p)) for p in path)
    out["state/" + key] = np.asarray(leaf)
for k, v in batch.items():
    out["batch/" + k] = np.asarray(v)
with jax.set_mesh(mesh):
    for ga in (1, 2):
        ts = step_mod.make_train_step(cfg, rules, oc, grad_accum=ga)
        f = jax.jit(ts, in_shardings=(sh(st_specs), sh(b_specs)))
        compiled = f.lower(sds, batch).compile()
        if ga == 1:
            out["argument_bytes"] = np.int64(
                compiled.memory_analysis().argument_size_in_bytes)
        state = jax.device_put(state0, sh(st_specs))
        b = jax.device_put(batch, sh(b_specs))
        losses = []
        for _ in range(2):
            state, m = compiled(state, b)
            losses.append(float(m["loss"]))
        out[f"losses_ga{ga}"] = np.asarray(losses)
np.savez(sys.argv[1], **out)
print("OK")
"""

#: The reference cell's reduced config.
CELL = dict(d_model=64, d_ff=32, vocab_size=512, n_heads=4, n_kv_heads=2)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "reference.npz")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                          path], env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    with np.load(path) as data:
        return dict(data)


def _cell_cfg():
    return dataclasses.replace(
        configs.get("granite-moe-1b-a400m").reduced(), **CELL)


def _cell_state(ref):
    """The reference's initial train state (numpy) as the port's."""
    tree = partition.nest(
        (tuple(k.split("/")[1:]), v) for k, v in ref.items()
        if k.startswith("state/"))
    return convert.train_state_from_numpy(_cell_cfg(), tree, "cpu")


def _cell_batch(ref):
    return {k: torch.as_tensor(ref["batch/" + k]) for k in ("tokens",
                                                            "labels")}


# -- pipeline ----------------------------------------------------------------


def test_pipeline_matches_the_reference(ref):
    mesh = mesh_mod.make_test_mesh((8,), ("stage",))
    rng = np.random.RandomState(0)
    ws = torch.as_tensor(rng.randn(8, 16, 16) * 0.3, dtype=torch.float32)
    mbs = torch.as_tensor(rng.randn(4, 2, 16), dtype=torch.float32)
    f = pipeline.pipeline_forward(mesh, lambda p, x: torch.tanh(x @ p["w"]),
                                  "stage")
    got = f({"w": ws}, mbs)
    assert got.spec == P() and got.shape == (4, 2, 16)
    np.testing.assert_allclose(got.full().numpy(), ref["pipe_out"],
                               atol=1e-5, rtol=0)


def test_pipeline_runs_the_ports_blocks():
    cfg = configs.get("hymba-1.5b").reduced()
    cfg = dataclasses.replace(cfg, n_layers=4, global_layers=(0, 3))
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(3, 2, 40, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    mesh = mesh_mod.make_test_mesh((2,), ("stage",))
    stages = pipeline.stage_layers(list(model.layers), 2)
    assert [s.layer_ids for s in stages] == [(0, 1), (2, 3)]
    with torch.no_grad():
        got = pipeline.pipeline_forward(
            mesh, pipeline.blocks_stage_fn(cfg))(stages, x).full()
        pos = torch.arange(40)
        want = torch.stack([tfm.run_stack(cfg, model.layers, xm, pos)[0]
                            for xm in x])
    assert torch.equal(got, want)


# -- elastic -----------------------------------------------------------------


def test_elastic_reshard_roundtrip_matches_the_reference(ref):
    m1 = mesh_mod.make_test_mesh((4, 2))
    m2 = mesh_mod.make_test_mesh((2, 4))
    rng = np.random.RandomState(0)
    tree = {"w": torch.as_tensor(rng.randn(16, 8), dtype=torch.float32),
            "b": torch.as_tensor(rng.randn(8), dtype=torch.float32)}
    specs = {"w": P("data", "model"), "b": P(None)}
    on1 = elastic.reshard(tree, specs, m1)
    on2 = elastic.rescale_checkpoint(
        {k: v.full().numpy() for k, v in on1.items()}, specs, m2)
    np.testing.assert_array_equal(on2["w"].full().numpy(), ref["elastic_w"])
    assert on2["w"].mesh.shape["data"] == 2
    for name, on in (("m1", on1), ("m2", on2)):
        got = [[(s.start, s.stop) for s in on["w"].index(i)]
               for i in range(8)]
        np.testing.assert_array_equal(got, ref["elastic_index_" + name])
        for i, t in enumerate(on["w"].shards):
            assert torch.equal(t, tree["w"][on["w"].index(i)])
    with pytest.raises(ValueError, match="does not split"):
        mesh_mod.device_put(torch.zeros(6, 8), m2, P("model"))


def test_restored_train_state_moves_between_meshes(tmp_path):
    cfg = configs.get("granite-moe-1b-a400m").reduced()
    oc = opt_mod.AdamWConfig(quantize_state=True, block=64)
    state = step_mod.init_train_state(cfg, oc, 0, "cpu")
    ckpt.save(str(tmp_path), 0, convert.train_state_to_numpy(cfg, state))
    _, tree = ckpt.restore(str(tmp_path),
                           convert.train_state_to_numpy(cfg, state))
    rules = ShardRules()
    m22 = mesh_mod.make_test_mesh((2, 2))
    m41 = mesh_mod.make_test_mesh((4, 1))
    on22 = step_mod.shard_train_state(cfg, rules, oc, tree, m22)
    specs41 = step_mod.train_state_specs(cfg, rules, oc, m41.shape)
    on41 = elastic.reshard(on22, specs41, m41)
    back = step_mod.shard_train_state(cfg, rules, oc, on41, m22)
    is_leaf = lambda x: isinstance(x, mesh_mod.Sharded)
    flat = partition.tree_leaves(on22, is_leaf)
    assert len(flat) == len(partition.tree_leaves(back, is_leaf))
    for a, b, c in zip(flat, partition.tree_leaves(on41, is_leaf),
                       partition.tree_leaves(back, is_leaf)):
        if isinstance(a, mesh_mod.Sharded):
            assert torch.equal(a.full(), c.full()) and a.spec == c.spec
            assert torch.equal(a.full(), b.full())
            assert b.mesh == m41
    emb = on41["params"]["embed"]
    assert emb.spec == P("model", "data") and emb.local_shape == (512, 32)


# -- the mesh train step -----------------------------------------------------


def _same_state(cfg, unsharded, on_mesh):
    leaves = convert.reference_leaves(cfg, unsharded["params"])
    for leaf, p in zip(leaves, partition.tree_leaves(on_mesh["params"]),
                       strict=True):
        assert torch.equal(leaf.gather(), p.full()), leaf.path
    is_m = lambda x: isinstance(x, (mesh_mod.Sharded, opt_mod.Quant8))
    for name in ("m", "v"):
        for a, b in zip(unsharded["opt"][name], partition.tree_leaves(
                on_mesh["opt"][name], is_m), strict=True):
            if isinstance(a, opt_mod.Quant8):
                assert torch.equal(a.q, b.q.full())
                assert torch.equal(a.hi, b.hi.full())
            else:
                assert torch.equal(a, b.full())
    assert int(unsharded["opt"]["step"]) == int(on_mesh["opt"]["step"].full())


@pytest.mark.parametrize("opt8", [False, True])
def test_mesh_step_equals_grad_accum_bit_for_bit(ref, opt8):
    cfg = _cell_cfg()
    oc = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                             quantize_state=opt8, block=64)
    rules = ShardRules()
    mesh = mesh_mod.make_test_mesh()
    batch = _cell_batch(ref)
    state = _cell_state(ref)
    if opt8:
        state["opt"] = opt_mod.init_state(
            oc, convert.reference_leaves(cfg, state["params"]))
    on_mesh = step_mod.shard_train_state(cfg, rules, oc, state, mesh)
    wq = on_mesh["params"]["layers"]["attn"]["wq"]["w"]
    assert wq.spec == P(None, "data", "model") and wq.local_shape == (
        2, 32, 32)
    ts_mesh = step_mod.make_train_step(cfg, rules, oc, mesh=mesh)
    ts = step_mod.make_train_step(cfg, rules, oc, grad_accum=2)
    losses = []
    for _ in range(2):
        on_mesh, m_mesh = ts_mesh(on_mesh, batch)
        state, m = ts(state, batch)
        for k in m:
            assert torch.equal(m[k], m_mesh[k]), k
        losses.append(float(m_mesh["loss"]))
    _same_state(cfg, state, on_mesh)
    assert on_mesh["step"] == state["step"] == 2
    if not opt8:
        want = ref["losses_ga2"]
        np.testing.assert_allclose(losses, want, rtol=1e-5, atol=0)
        print("losses", losses, "reference ga2", want, "ga1",
              ref["losses_ga1"])


def test_dry_run_argument_bytes_equal_xla(ref):
    cfg = _cell_cfg()
    oc = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    rules = ShardRules()
    sizes = {"data": 2, "model": 4}
    p_sds = partition.param_shapes(
        cfg, tfm.init_params(cfg, torch.Generator().manual_seed(0)).float())
    state_sds = {"params": p_sds, "opt": partition.opt_shapes(oc, p_sds),
                 "step": ShapeDtype((), torch.int32)}
    batch_sds = {k: ShapeDtype((8, 16), torch.int32) for k in ("tokens",
                                                               "labels")}
    specs = (step_mod.train_state_specs(cfg, rules, oc, sizes),
             partition.fit_tree(partition.batch_specs(batch_sds, rules),
                                batch_sds, sizes))
    got = dryrun.argument_bytes((state_sds, batch_sds), specs, sizes)
    assert got == int(ref["argument_bytes"])


def test_one_d_consumers_refuse_a_multi_axis_mesh():
    from repro_torch.api import compiled as tcompiled
    from repro_torch.api.fleet import compile_fleet
    from repro_torch.core import trainer as ttrainer
    from test_torch_fleet import tiny_machine
    from test_torch_montecarlo import _tiny_candidates

    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=40).astype(np.int32)
    for axis, call in (
        ("pairgrid", lambda m: ttrainer.family_cv_grid(
            ttrainer.pad_pairs(np.random.RandomState(0).rand(30, 2),
                               np.arange(30) % 2, 2),
            "rbf", np.array([1.0]), np.array([1.0]), 5, mesh=m)),
        ("variants", lambda m: tcompiled.compile_mc_stream(
            _tiny_candidates("port"), n_classes=3, key=0, mc_chunk=8,
            device="cpu").stream(x, y, np.ones((1, 3), bool), n_variants=4,
                                 accuracy_floor=0.5, mesh=m)),
        ("batch", lambda m: compile_fleet({"a": tiny_machine(6)}).shard(m)),
    ):
        two_d = mesh_mod.make_test_mesh((2, 2), (axis, "model"))
        with pytest.raises(ValueError, match=f"1-D mesh over '{axis}'"):
            call(two_d)


# -- compression -------------------------------------------------------------


@pytest.mark.parametrize("shape,block", [((32, 16), 64), ((7, 33), 256),
                                         ((1000,), 256)])
def test_quantize_block_equals_the_reference(shape, block):
    rng = np.random.RandomState(sum(shape))
    x = (rng.randn(*shape) * 3).astype(np.float32)
    err = (rng.randn(*shape) * 1e-3).astype(np.float32)
    r_q, r_s = r_comp.quantize_block(jnp.asarray(x), block)
    q, s = compression.quantize_block(torch.as_tensor(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(r_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(r_s))
    np.testing.assert_array_equal(
        compression.dequantize_block(q, s, shape).numpy(),
        np.asarray(r_comp.dequantize_block(r_q, r_s, shape)))
    r_out = r_comp.compress_with_feedback(jnp.asarray(x), jnp.asarray(err),
                                          block)
    out = compression.compress_with_feedback(torch.as_tensor(x),
                                             torch.as_tensor(err), block)
    for a, b in zip(out, r_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _reference_allreduce(g, e, block):
    """Eager: XLA's fusion of the jitted function moves the mean by up to
    2 ulps and the residuals by a rounding (a reciprocal or FMA)."""
    f = r_comp.compressed_psum_fn("data", block)
    return jax.vmap(f, axis_name="data")(jnp.asarray(g), jnp.asarray(e))


def test_compressed_allreduce_equals_the_reference():
    rng = np.random.RandomState(0)
    g = rng.randn(8, 32, 16).astype(np.float32)
    e = (rng.randn(8, 32, 16) * 1e-2).astype(np.float32)
    r_mean, r_err = _reference_allreduce(g, e, 64)
    mesh = mesh_mod.make_test_mesh((8,), ("data",))
    ar = compression.make_compressed_allreduce(mesh, "data", block=64)
    mean, errs = ar({"w": torch.as_tensor(g)}, {"w": torch.as_tensor(e)})
    assert mean["w"].spec == P() and errs["w"].spec == P("data")
    got = mean["w"].full().numpy()
    want = np.asarray(r_mean)[0]
    np.testing.assert_array_equal(np.asarray(r_mean)[3], want)
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()
    np.testing.assert_array_equal(errs["w"].full().numpy(), np.asarray(r_err))
    codes, scale, _ = compression.encode_shares(
        [torch.as_tensor(x) for x in g], [torch.as_tensor(x) for x in e], 64)
    assert all(q.dtype == torch.int8 for q in codes)
    # the common scale: every share's residual is within half its step
    for i in range(8):
        assert np.all(np.abs(np.asarray(r_err)[i]).reshape(-1, 64)
                      <= scale.numpy() * (0.5 + 1e-6))


def test_compressed_allreduce_error_feedback():
    """tests/test_distributed.py's property: the int8 error bound, and the
    running mean of 20 repeats at least halves the error."""
    mesh = mesh_mod.make_test_mesh((8,), ("data",))
    ar = compression.make_compressed_allreduce(mesh, "data", block=64)
    rng = np.random.RandomState(0)
    g = torch.as_tensor(rng.randn(8, 32, 16), dtype=torch.float32)
    grads, errs = {"w": g}, {"w": torch.zeros_like(g)}
    mean1, errs = ar(grads, errs)
    true_mean = g.mean(0)
    err1 = float((mean1["w"].full() - true_mean).abs().max())
    assert err1 < 0.05, err1
    acc = torch.zeros_like(true_mean)
    for _ in range(20):
        m, errs = ar(grads, errs)
        acc += m["w"].full()
    err20 = float((acc / 20 - true_mean).abs().max())
    assert err20 < err1 / 2, (err20, err1)

"""The port's training substrate against the JAX reference, on the CPU.

Optimizer (``training/optimizer.py``): AdamW's params and moments after 3
updates on random f32 leaves within 1e-6; ``Quant8`` codes equal on >=
99.9 % of entries and within one code elsewhere (XLA's and PyTorch's log
round a few ties apart); ``lr_schedule`` equal through the warmup and
within 4 f32 ulp of the cosine after it.

Train step (``training/step.py``, ``models/transformer.forward_train``):
the reference's twins (clip, the quadratic, ``grad_accum=2`` = 1 within
its 2e-5), then each family's reduced config (2 layers, d_model 128, f32;
B = 2, S = 40) with the reference's own initial train state carried in by
``convert.train_state_from_numpy``: the loss within 1e-5 relative, every
gradient leaf within 1e-4 * max(1, max|g_ref|), and the parameters after
one step within 2e-5 wherever |g_ref| > 1e-4.  Elsewhere Adam's first step
is about ``lr * sign(g)``, and a gradient near 0 may take either sign in
the two packages, so those entries are held to 2 lr (1 + wd) and counted.
The ssm and hybrid layers' scans are differentiated by ``ops.SSDScan`` (its
plain twin here), one backward pass per layer.  Then ``remat`` none / full
/ dots within 1e-6 (moe, hybrid, ssm) and ``cast_params_bf16`` within 2e-2
of the reference's loss.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import transformer as r_tfm
from repro.models.common import ShardRules
from repro.training import optimizer as r_opt
from repro.training import step as r_step
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import (
    reference_leaves, train_state_from_numpy, train_state_to_numpy,
)
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import step as step_mod

RULES = ShardRules()
B, S = 2, 40
#: The reference's init, jitted with its configs static (its eager init
#: dispatches an op at a time and takes seconds).
R_INIT_STATE = jax.jit(r_step.init_train_state, static_argnums=(0, 1))
FAMILIES = {"dense": "granite-20b", "moe": "granite-moe-1b-a400m",
            "ssm": "mamba2-2.7b", "hybrid": "hymba-1.5b",
            "vlm": "phi-3-vision-4.2b", "audio": "whisper-medium"}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _random_leaves(seed):
    rng = np.random.RandomState(seed)
    shapes = [(300,), (17, 33), (2, 5, 70), (256,), (3, 256)]
    return [rng.randn(*s).astype(np.float32) for s in shapes]


# -- optimizer ---------------------------------------------------------------


@pytest.mark.parametrize("quantize", [False, True])
def test_apply_updates_matches_the_reference_over_three_steps(quantize):
    oc = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              quantize_state=quantize, block=64)
    r_oc, oc = r_opt.AdamWConfig(**oc), opt_mod.AdamWConfig(**oc)
    params = _random_leaves(0)
    r_p = [jnp.asarray(p) for p in params]
    p = [torch.from_numpy(x.copy()) for x in params]
    r_state, state = r_opt.init_state(r_oc, r_p), opt_mod.init_state(oc, p)
    upd = functools.partial(r_opt.apply_updates, r_oc)
    for i in range(3):
        grads = _random_leaves(10 + i)
        r_p, r_state = upd(r_p, r_state, [jnp.asarray(g) for g in grads])
        p, state = opt_mod.apply_updates(
            oc, p, state, [torch.from_numpy(g) for g in grads])
    assert int(state["step"]) == int(r_state["step"]) == 3
    for a, b in zip(r_p, p):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=0)
    for key in ("m", "v"):
        for a, b in zip(r_state[key], state[key]):
            if quantize:
                a, b = a.decode(), b.decode()
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       atol=1e-6, rtol=3e-2 if quantize
                                       else 1e-6)


@pytest.mark.parametrize("shape", [(300,), (17, 33), (256,), (2, 5, 70)])
def test_zero_moments_are_the_codes_of_zeros(shape):
    """The 8-bit zero state (``Quant8.zeros``, built without encoding)
    equals ``Quant8.encode`` of a zero leaf bit for bit."""
    oc = opt_mod.AdamWConfig(quantize_state=True, block=64)
    got = opt_mod._zeros_state(oc, torch.empty(shape))
    want = opt_mod.Quant8.encode(torch.zeros(shape), oc.block)
    assert torch.equal(got.q, want.q) and torch.equal(got.hi, want.hi)
    assert got.shape == want.shape == shape


@pytest.mark.parametrize("quantize", [False, True])
def test_update_leaf_in_chunks_equals_the_whole_leaf(quantize, monkeypatch):
    """A leaf above ``UPDATE_CHUNK`` entries is updated chunk by chunk (a
    ragged last chunk, a transposed view, a 1-d leaf without decay) with
    the whole leaf's result, codes and all, bit for bit."""
    oc = opt_mod.AdamWConfig(lr=1e-2, quantize_state=quantize, block=64)
    rng = np.random.RandomState(5)
    leaves = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in ((3000,), (17, 129))]
    leaves.append(torch.from_numpy(rng.randn(40, 60).astype(np.float32)).T)
    step, lr, bc1, bc2 = opt_mod.step_scalars(oc, torch.tensor(4))
    for p in leaves:
        g = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
        m, v = (opt_mod._zeros_state(oc, p) for _ in range(2))
        m, v = (opt_mod.update_leaf(oc, p, g, m, v, lr, bc1, bc2)[i]
                for i in (1, 2))
        runs = []
        for chunk in (1 << 24, 512):
            monkeypatch.setattr(opt_mod, "UPDATE_CHUNK", chunk)
            runs.append(opt_mod.update_leaf(oc, p, 2 * g, m, v, lr, bc1, bc2))
        (p1, m1, v1), (p2, m2, v2) = runs
        assert torch.equal(p1, p2) and p2.shape == p.shape
        for a, b in ((m1, m2), (v1, v2)):
            if quantize:
                assert torch.equal(a.q, b.q) and torch.equal(a.hi, b.hi)
                assert a.shape == b.shape
            else:
                assert torch.equal(a, b)


@pytest.mark.parametrize("scale", [1e-8, 1e-3, 1.0, 1e3])
def test_quant8_codes_match_the_reference(scale):
    rng = np.random.RandomState(3)
    x = (rng.randn(5000) * scale * np.exp(rng.randn(5000) * 3)).astype(
        np.float32)
    x[::97] = 0.0
    r_q = r_opt.Quant8.encode(jnp.asarray(x), 256)
    q = opt_mod.Quant8.encode(torch.from_numpy(x), 256)
    assert q.q.dtype == torch.int8 and tuple(q.q.shape) == r_q.q.shape
    np.testing.assert_allclose(q.hi.numpy(), np.asarray(r_q.hi), rtol=1e-6)
    diff = np.abs(q.q.numpy().astype(int) - np.asarray(r_q.q).astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999
    back = q.decode().numpy()
    assert back.shape == x.shape and np.all(back[x == 0] == 0)
    same = (diff == 0).reshape(-1)[:x.size]
    np.testing.assert_allclose(back[same], np.asarray(r_q.decode())[same],
                               rtol=1e-5)


def test_lr_schedule_matches_the_reference_at_every_step():
    """Equal to the reference's eager f32 schedule at every step, to the
    last bits of its cosine: XLA's and PyTorch's cos round a few steps an
    ulp apart, which ``1 + cos`` magnifies near the end of the decay (XLA's
    jitted schedule differs from its own eager one as much)."""
    for kw in (dict(lr=3e-4, warmup_steps=20, total_steps=100),
               dict(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)):
        r_oc, oc = r_opt.AdamWConfig(**kw), opt_mod.AdamWConfig(**kw)
        steps = np.arange(0, kw["total_steps"] + 5, dtype=np.int32)
        want = np.array([np.float32(r_opt.lr_schedule(r_oc, jnp.int32(s)))
                         for s in steps])
        got = opt_mod.lr_schedule(oc, torch.from_numpy(steps)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got[:kw["warmup_steps"]],
                                      want[:kw["warmup_steps"]])
        np.testing.assert_array_max_ulp(got, want, maxulp=4)
        assert (got == want).mean() >= 0.9


def test_clip_by_global_norm():
    a = torch.tensor([3.0, 4.0])                    # norm 5
    (clipped,), norm = step_mod.clip_by_global_norm([a], 1.0)
    assert abs(float(norm) - 5.0) < 1e-5
    assert abs(float(torch.linalg.norm(clipped)) - 1.0) < 1e-5
    (same,), _ = step_mod.clip_by_global_norm([a], 10.0)
    np.testing.assert_allclose(same.numpy(), [3.0, 4.0])


def test_adamw_quadratic_convergence():
    oc = opt_mod.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200,
                             weight_decay=0.0)
    w = [torch.tensor([3.0, -2.0])]
    opt = opt_mod.init_state(oc, w)
    target = torch.tensor([1.0, 1.0])
    for _ in range(150):
        w, opt = opt_mod.apply_updates(oc, w, opt, [2 * (w[0] - target)])
    np.testing.assert_allclose(w[0].numpy(), target.numpy(), atol=0.05)


def _tokens_batch(cfg, seed=0, b=B, s=S):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.randn(b, cfg.n_patches, cfg.d_model
                                          ).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.randn(b, 48, cfg.d_model).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def test_grad_accum_equals_full_batch():
    """grad_accum=2 on the batch == one step on it, within the reference's
    2e-5, on every parameter leaf."""
    cfg = configs.get("granite-20b").reduced()
    oc = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _torch_batch(_tokens_batch(cfg, b=4, s=16))
    outs = []
    for ga in (1, 2):
        state = step_mod.init_train_state(cfg, oc, 0, "cpu")
        state, m = step_mod.make_train_step(cfg, oc, grad_accum=ga)(state,
                                                                     batch)
        outs.append([p.detach().clone() for p in state["params"].parameters()])
        assert np.isfinite(float(m["loss"]))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=0)


# -- the whole train step, per family -----------------------------------------


def _reference_step(r_cfg, r_oc, cast=False):
    """Jitted: the reference's gradient of forward_train and its train
    step on one state and batch."""
    ts = r_step.make_train_step(r_cfg, RULES, r_oc, cast_params_bf16=cast)

    def run(state, batch):
        grads = jax.grad(lambda p: r_tfm.forward_train(
            r_cfg, p, batch, RULES)[0])(state["params"])
        new, metrics = ts(state, batch)
        return grads, new, metrics

    return jax.jit(run)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_matches_the_reference(family):
    arch = FAMILIES[family]
    cfg, r_cfg = configs.get(arch).reduced(), r_configs.get(arch).reduced()
    kw = dict(warmup_steps=2)
    r_oc, oc = r_opt.AdamWConfig(**kw), opt_mod.AdamWConfig(**kw)
    r_state = R_INIT_STATE(r_cfg, r_oc, jax.random.PRNGKey(0))
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, r_state),
                                   "cpu")
    batch = _tokens_batch(cfg)
    r_grads, r_new, r_m = _reference_step(r_cfg, r_oc)(
        r_state, {k: jnp.asarray(v) for k, v in batch.items()})

    tb = _torch_batch(batch)
    ops.reset_launches()
    loss, _ = tfm.forward_train(cfg, state["params"], tb)
    loss.backward()
    # ssm / hybrid layers' scans go through SSDScan (its plain twin here).
    scans = cfg.n_layers if family in ("ssm", "hybrid") else 0
    assert ops.launch_counts()["ssd_scan_backward"] == scans
    leaves = reference_leaves(cfg, state["params"])
    r_g = _leaves(r_grads)
    assert len(r_g) == len(leaves)
    for leaf, want in zip(leaves, r_g):
        got = leaf.gather(lambda t: t.grad).numpy()
        np.testing.assert_allclose(
            got, want, atol=1e-4 * max(1.0, float(np.abs(want).max())),
            rtol=0, err_msg=str(leaf.path))
        assert np.abs(got).max() > 0, leaf.path

    new, m = step_mod.make_train_step(cfg, oc)(state, tb)
    assert abs(float(m["loss"]) - float(r_m["loss"])) <= \
        1e-5 * abs(float(r_m["loss"]))
    np.testing.assert_allclose(float(m["grad_norm"]), float(r_m["grad_norm"]),
                               rtol=1e-5)
    got_p = _leaves(train_state_to_numpy(cfg, new)["params"])
    bound = 2 * oc.lr * (1 + oc.weight_decay)
    loose = 0
    for got, want, g in zip(got_p, _leaves(r_new["params"]), r_g):
        live = np.abs(g) > 1e-4
        np.testing.assert_allclose(got[live], want[live], atol=2e-5, rtol=0)
        assert np.all(np.abs(got - want)[~live] <= bound)
        loose += int((np.abs(got - want)[~live] > 2e-5).sum())
    assert loose <= 0.01 * sum(p.size for p in got_p), loose


@pytest.mark.parametrize("family", ["moe", "hybrid", "ssm"])
def test_remat_policies_give_the_same_gradients(family):
    base = configs.get(FAMILIES[family]).reduced()
    batch = _torch_batch(_tokens_batch(base))
    grads = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        state = step_mod.init_train_state(cfg, opt_mod.AdamWConfig(), 0, "cpu")
        ops.reset_launches()
        loss, _ = tfm.forward_train(cfg, state["params"], batch)
        loss.backward()
        grads[remat] = [t.grad for t in state["params"].parameters()]
    for remat in ("full", "dots"):
        for a, b in zip(grads["none"], grads[remat]):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6,
                                       rtol=0)


def test_remat_checkpoints_only_when_a_graph_is_built():
    cfg = dataclasses.replace(configs.get("granite-20b").reduced(),
                              remat="full")
    state = step_mod.init_train_state(cfg, opt_mod.AdamWConfig(), 0, "cpu")
    p, x = state["params"].layers[0], torch.zeros(1, 2, cfg.d_model)
    assert tfm._remat(cfg, tfm.block_forward, p, x) is not tfm.block_forward
    with torch.no_grad():
        assert tfm._remat(cfg, tfm.block_forward, p, x) is tfm.block_forward
    for t in p.parameters():
        t.requires_grad_(False)
    assert tfm._remat(cfg, tfm.block_forward, p, x) is tfm.block_forward


def test_cast_params_bf16_loss_matches_the_reference():
    arch = FAMILIES["dense"]
    cfg, r_cfg = configs.get(arch).reduced(), r_configs.get(arch).reduced()
    r_oc, oc = r_opt.AdamWConfig(), opt_mod.AdamWConfig()
    r_state = R_INIT_STATE(r_cfg, r_oc, jax.random.PRNGKey(0))
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, r_state),
                                   "cpu")
    batch = _tokens_batch(cfg)
    _, _, r_m = _reference_step(r_cfg, r_oc, cast=True)(
        r_state, {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = step_mod.make_train_step(cfg, oc, cast_params_bf16=True)(
        state, _torch_batch(batch))
    assert abs(float(m["loss"]) - float(r_m["loss"])) <= \
        2e-2 * abs(float(r_m["loss"]))
    assert all(t.dtype == torch.float32 for t in new["params"].parameters())
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0


def test_step_state_and_metrics():
    cfg = configs.get("granite-moe-1b-a400m").reduced()
    oc = opt_mod.AdamWConfig(warmup_steps=3)
    state = step_mod.init_train_state(cfg, oc, 0, "cpu")
    assert all(t.requires_grad and t.dtype == torch.float32
               for t in state["params"].parameters())
    ts = step_mod.make_train_step(cfg, oc, grad_accum=2)
    batch = _torch_batch(_tokens_batch(cfg, b=4))
    for i in range(2):
        state, m = ts(state, batch)
    assert state["step"] == 2 and int(state["opt"]["step"]) == 2
    assert set(m) == {"xent", "zloss", "ppl_tokens", "moe_aux", "loss",
                      "grad_norm", "lr"}
    assert float(m["ppl_tokens"]) == 2 * S
    assert all(t.grad is None for t in state["params"].parameters())
    with pytest.raises(ValueError, match="microbatches"):
        step_mod.make_train_step(cfg, oc, grad_accum=3)(state, batch)

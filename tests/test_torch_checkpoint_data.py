"""Checkpoints, the token pipeline and the training launcher of the port,
on the CPU.

Twins of ``tests/test_checkpoint_data.py`` (round trip, auto-resume, a
crashed ``.tmp``, corruption, atomic overwrite; the pipeline's determinism,
host shards and resume), then the two packages against each other: the
same tokens bit for bit, and a train state saved by either package
restored by the other bit for bit (f32 and 8-bit moments).  Last,
``launch.train.main`` resumed from its step-2 checkpoint gives the
continuous run's losses bit for bit.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as r_ckpt
from repro import configs as r_configs
from repro.data import pipeline as r_pipeline
from repro.models import transformer as r_tfm
from repro.training import optimizer as r_opt
from repro.training import step as r_step
from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch import train
from repro_torch.models.convert import (
    params_from_numpy, params_to_numpy, train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import step as step_mod

#: The reference's init, jitted with its config static (eager, it
#: dispatches an op at a time and takes seconds).
R_INIT = jax.jit(r_tfm.init_params, static_argnums=0)


def _tree():
    return {"a": np.arange(12.0, dtype=np.float32).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.int32)},
            "step": np.int32(7)}


def _flat(tree):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for _, x in ckpt.checkpoint._leaf_files(tree)]


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 3, _tree())
    step, back = ckpt.restore(d, _tree())
    assert step == 3
    for x, y in zip(_flat(_tree()), _flat(back)):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


def test_latest_step_and_autoresume(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    for s in (1, 5, 3):
        ckpt.save(d, s, _tree())
    assert ckpt.latest_step(d) == 5


def test_crashed_save_is_ignored(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 2, _tree())
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert ckpt.latest_step(d) == 2
    step, _ = ckpt.restore(d, _tree())
    assert step == 2


def test_corruption_detected(tmp_path):
    d = str(tmp_path)
    path = ckpt.save(d, 1, _tree())
    target = os.path.join(path, "a.npy")
    arr = np.load(target)
    arr[0, 0] += 1000.0
    np.save(target, arr)
    with pytest.raises(IOError, match="corruption"):
        ckpt.restore(d, _tree())


def test_missing_leaf_raises(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"a": np.zeros(3)})
    with pytest.raises(KeyError, match="b"):
        ckpt.restore(d, {"a": None, "b": None})


def test_atomic_overwrite(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 4, _tree())
    ckpt.save(d, 4, _tree())
    step, _ = ckpt.restore(d, _tree())
    assert step == 4


# -- data pipeline --------------------------------------------------------------


def test_pipeline_deterministic_and_seekable():
    cfg = PipelineConfig(vocab_size=100, seq_len=32, global_batch=8, seed=1)
    b17a, b17b = TokenPipeline(cfg).batch_at(17), TokenPipeline(cfg).batch_at(17)
    np.testing.assert_array_equal(b17a["tokens"], b17b["tokens"])
    np.testing.assert_array_equal(b17a["tokens"][:, 1:],
                                  b17a["labels"][:, :-1])


def test_pipeline_host_shards_disjoint_and_union():
    base = dict(vocab_size=50, seq_len=16, global_batch=8, seed=3)
    full = TokenPipeline(PipelineConfig(**base)).batch_at(5)["tokens"]
    parts = [TokenPipeline(PipelineConfig(**base, host_index=i, host_count=4)
                           ).batch_at(5)["tokens"] for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts, 0), full)
    with pytest.raises(ValueError, match="split"):
        PipelineConfig(**dict(base, global_batch=6), host_count=4).host_batch


def test_pipeline_resume_equals_continuous():
    cfg = PipelineConfig(vocab_size=64, seq_len=8, global_batch=4, seed=9)
    p = TokenPipeline(cfg)
    cont = [p.batch_at(s)["tokens"] for s in range(6)]
    resumed = [TokenPipeline(cfg).batch_at(s)["tokens"] for s in (3, 4, 5)]
    for a, b in zip(cont[3:], resumed):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=100, seq_len=32, global_batch=8, seed=1),
    dict(vocab_size=49155, seq_len=300, global_batch=4, seed=0,
         host_index=1, host_count=2)])
def test_tokens_equal_the_reference_bit_for_bit(kw):
    ours = TokenPipeline(PipelineConfig(**kw))
    theirs = r_pipeline.TokenPipeline(r_pipeline.PipelineConfig(**kw))
    for step in (0, 3, 11):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])
        dev = ours.device_batch_at(step, "cpu")
        np.testing.assert_array_equal(dev["tokens"].numpy(), b["tokens"])
        np.testing.assert_array_equal(dev["labels"].numpy(), b["labels"])


# -- the two packages' checkpoints ---------------------------------------------


def _states(arch, opt8):
    """The reference's init train state with nonzero moments (f32, or
    ``Quant8`` codes of them) and step 1."""
    r_cfg, cfg = r_configs.get(arch).reduced(), configs.get(arch).reduced()
    params = R_INIT(r_cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)

    def moment(p, scale):
        x = rng.randn(*p.shape).astype(np.float32) * scale
        if not opt8:
            return jnp.asarray(x)
        q = opt_mod.Quant8.encode(torch.from_numpy(x), 256)
        return r_opt.Quant8(q=jnp.asarray(q.q.numpy()),
                            hi=jnp.asarray(q.hi.numpy()), shape=p.shape)

    opt = {"m": jax.tree.map(lambda p: moment(p, 1e-3), params),
           "v": jax.tree.map(lambda p: moment(p, 1e-6) ** 2 if not opt8
                             else moment(p, 1e-6), params),
           "step": jnp.int32(1)}
    return cfg, {"params": params, "opt": opt, "step": jnp.int32(1)}


def _ref_leaves(path):
    return {f[:-4]: np.load(os.path.join(path, f))
            for f in os.listdir(path) if f.endswith(".npy")}


@pytest.mark.parametrize("arch,opt8", [("granite-moe-1b-a400m", False),
                                       ("granite-moe-1b-a400m", True),
                                       ("whisper-medium", False),
                                       ("hymba-1.5b", True)])
def test_checkpoints_cross_between_the_packages(tmp_path, arch, opt8):
    cfg, r_state = _states(arch, opt8)
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, r_state),
                                   "cpu")
    # The reference saves, the port restores.
    r_dir, dir_ = str(tmp_path / "ref"), str(tmp_path / "port")
    r_path = r_ckpt.save(r_dir, 1, r_state)
    fresh = step_mod.init_train_state(
        cfg, opt_mod.AdamWConfig(quantize_state=opt8), 5, "cpu")
    step, tree = ckpt.restore(r_dir, train_state_to_numpy(cfg, fresh))
    back = train_state_from_numpy(cfg, tree, "cpu")
    assert step == 1 and back["step"] == 1 and int(back["opt"]["step"]) == 1
    # The port saves what it restored: the same files, bit for bit.
    path = ckpt.save(dir_, 1, train_state_to_numpy(cfg, back))
    want, got = _ref_leaves(r_path), _ref_leaves(path)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # The reference restores the port's save into its own init's tree.
    r_fresh = jax.eval_shape(functools.partial(
        r_step.init_train_state, r_configs.get(arch).reduced(),
        r_opt.AdamWConfig(quantize_state=opt8)), jax.random.PRNGKey(3))
    _, r_back = r_ckpt.restore(dir_, r_fresh)
    for a, b in zip(jax.tree.leaves(r_back), jax.tree.leaves(r_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # And the carried state is the state: parameters bit for bit.
    for a, b in zip(jax.tree.leaves(params_to_numpy(cfg, state["params"])),
                    jax.tree.leaves(r_state["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_params_round_trip_through_the_reference_layout():
    cfg = configs.get("hymba-1.5b").reduced()
    model = step_mod.init_train_state(cfg, opt_mod.AdamWConfig(), 1,
                                      "cpu")["params"]
    tree = params_to_numpy(cfg, model)
    assert tree["layers"]["attn"]["wq"]["w"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim)
    again = params_from_numpy(cfg, tree, "cpu", torch.float32)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        np.testing.assert_array_equal(a.detach().numpy(), b.numpy(),
                                      err_msg=n)


def test_train_main_resumes_bit_for_bit(tmp_path, capsys):
    argv = ["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
            "--global-batch", "4", "--seq-len", "16", "--grad-accum", "2",
            "--warmup", "2", "--log-every", "1"]
    cont = train.main(argv + ["--steps", "4"])
    d = str(tmp_path / "ckpt")
    first = train.main(argv + ["--steps", "2", "--ckpt-dir", d])
    assert ckpt.latest_step(d) == 2
    rest = train.main(argv + ["--steps", "4", "--ckpt-dir", d])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step     4 loss" in out
    assert first + rest == cont
    assert all(np.isfinite(cont)) and len(cont) == 4


def test_train_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "granite-moe-1b-a400m", "--reduced"])
    args = train.build_parser().parse_args([])
    assert args.reduced is False and args.device is None


def test_train_main_reads_the_losses_at_log_lines(monkeypatch):
    """Each step's loss stays a device scalar until a log line or the end
    reads the pending ones at once; ``main`` returns them as floats."""
    losses, reads = {}, []         # id -> the loss itself, kept alive
    make = step_mod.make_train_step

    def tracked(*a, **k):
        ts = make(*a, **k)

        def step(state, batch):
            state, m = ts(state, batch)
            losses[id(m["loss"])] = m["loss"]
            return state, m
        return step

    stack = torch.stack

    def counted(tensors, *a, **k):
        if any(id(t) in losses for t in tensors):
            reads.append(len(tensors))
        return stack(tensors, *a, **k)

    to_float = torch.Tensor.__float__

    def no_float(t):
        assert id(t) not in losses, "a step's loss read on its own"
        return to_float(t)

    monkeypatch.setattr(step_mod, "make_train_step", tracked)
    monkeypatch.setattr(torch, "stack", counted)
    monkeypatch.setattr(torch.Tensor, "__float__", no_float)
    out = train.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                      "--device", "cpu", "--global-batch", "2",
                      "--seq-len", "16", "--steps", "5", "--log-every", "2"])
    assert reads == [2, 2, 1]
    assert len(out) == 5 and all(type(x) is float for x in out)

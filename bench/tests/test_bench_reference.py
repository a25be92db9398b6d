"""The plain reference (``bench/reference/lm.py``) held to the program at
a tiny width on the CPU, both in f32: the parameter tree, the loss and
every leaf's gradient, three AdamW steps, and the serve state a prefill
packs.  These tests import both; the reference imports nothing of the
program."""
from __future__ import annotations

import copy

import pytest
import torch

from bench.harness.program import Program
from bench.reference import lm
from bench.tests.tiny import tiny

CPU = torch.device("cpu")
NAMES = ("granite-moe-1b-a400m", "hymba-1.5b")


def f32_cell(name: str, kind: str = "train"):
    c = tiny(f"{name}.{kind}")
    c.config.update(dtype="float32")
    return c


def program_model(cfg, params):
    prog = Program(cfg, CPU)
    paths = [s[0] for s in lm.param_specs(cfg)]
    model = prog.model(lambda i: params[paths[i]].clone(), paths,
                       torch.float32)
    return prog, model


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("name", NAMES)
def test_the_parameter_trees_agree(name):
    cfg = f32_cell(name).config
    prog, model = program_model(cfg, lm.make_params(cfg, 3, CPU))
    specs = lm.param_specs(cfg)
    assert [lf.path for lf in prog.leaves(model)] == [s[0] for s in specs]
    assert [lf.shape for lf in prog.leaves(model)] == [s[1] for s in specs]


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_the_program(name):
    from repro_torch.models import transformer as tfm

    c = f32_cell(name)
    cfg = c.config
    params = lm.make_params(cfg, 11, CPU)
    prog, model = program_model(cfg, params)
    batch = c.traffic().Feed(c.mix, cfg, 11).batch(0, CPU)
    for t in model.parameters():
        t.requires_grad_(True)
    loss_p, _ = tfm.forward_train(prog.cfg, model, batch)
    loss_p.backward()
    with lm.precision("f32"):
        for t in params.values():
            t.requires_grad_(True)
        loss_r = lm.loss_fn(cfg, params, batch["tokens"], batch["labels"])
        loss_r.backward()
    assert float(loss_p.detach()) == pytest.approx(float(loss_r.detach()),
                                                   rel=1e-5)
    for lf in prog.leaves(model):
        want = params[lf.path].grad
        assert rel(lf.gather(lambda t: t.grad), want) < 1e-4, lf.path


@pytest.mark.parametrize("name", NAMES)
def test_three_adamw_steps_match_the_program(name):
    c = f32_cell(name)
    run = c.runner().Run(c, 5, CPU)
    run.setup()
    leaves = run.program.leaves(run.state["params"])
    got = {lf.path: lf.gather().clone() for lf in leaves}
    run.release()
    ref = run.reference()
    params = lm.make_params(c.config, 5, CPU)
    batches = [(b["tokens"], b["labels"]) for b in
               (run.feed.batch(k, CPU) for k in range(3))]
    job = dict(c.mix["optimizer"], grad_accum=c.mix["grad_accum"])
    with lm.precision("f32"):
        lm.train(c.config, job, params, batches)
    assert run.read["losses"] == pytest.approx(ref["losses"], rel=1e-5)
    for path, want in params.items():
        assert rel(got[path], want) < 1e-5, path
    numbers = run.numbers(ref)
    assert numbers["grad_norm_gap"] < 1e-4
    assert numbers["update_norm_gap"] < 1e-3


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("length", [48, 160])
def test_prefill_state_matches_the_program(name, length):
    from repro_torch.serving import engine

    cfg = f32_cell(name, "prefill").config
    params = lm.make_params(cfg, 2, CPU)
    prog, model = program_model(cfg, params)
    tokens = torch.randint(0, cfg["vocab_size"], (3, length),
                           generator=torch.Generator().manual_seed(1))
    cap = length + 8
    state, logits = engine.prefill(prog.cfg, model, {"tokens": tokens}, cap)
    with lm.precision("f32"):
        want, want_logits = lm.prefill(cfg, params, tokens, cap)
    assert set(state) == set(want)
    assert state["pos"] == want["pos"] == length
    for k, w in want.items():
        if torch.is_tensor(w):
            assert state[k].shape == w.shape, k
            assert rel(state[k], w) < 1e-5, k
    assert rel(logits, want_logits) < 1e-5


def test_fp8_rounds_every_product():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(64, 32, generator=g), torch.randn(32, 16, generator=g)
    q = lm.to_fp8(a)
    err = float((q - a).abs().max() / a.abs().max())
    assert 0 < err <= 2 ** -4
    with lm.precision("fp8"):
        low = lm.product("ij,jk->ik", a, b)
    with lm.precision("f32"):
        high = lm.product("ij,jk->ik", a, b)
    assert 1e-3 < rel(low, high) < 0.2
    x = a.clone().requires_grad_()
    with lm.precision("fp8"):
        lm.product("ij,jk->ik", x, b).sum().backward()
    assert rel(x.grad, b.sum(1).expand(64, 32)) < 0.2


def test_the_reference_leaves_no_flag_behind():
    before = torch.backends.cuda.matmul.allow_tf32
    with lm.precision("fp8"):
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert lm._MODE["prec"] == "fp8"
    assert torch.backends.cuda.matmul.allow_tf32 == before
    assert lm._MODE["prec"] == "f32"


def test_capacity_drops_the_latest_assignments():
    cfg = copy.deepcopy(f32_cell("granite-moe-1b-a400m").config)
    assert lm.capacity(cfg, 8192) == 8192 * 2 // 8 * 5 // 4
    assert lm.capacity(cfg, 1) == 1

"""The plain pure-SSM reference (``bench/reference/ssm.py``) held to the
program on the tiny ``mamba2-2.7b`` cell on the CPU, both in f32: the
parameter tree, the loss and every leaf's gradient, three AdamW steps with
8-bit moments, the moment code itself, and the serve state a prefill
packs; and mamba2's model FLOPs and kernel bounds at its training
microbatch."""
from __future__ import annotations

import math

import pytest
import torch

from bench.configs import model_flops
from bench.harness.peaks import H100_SXM
from bench.harness.program import Program
from bench.harness.work import Pass
from bench.metrics import k4_roofline, k4bwd_roofline
from bench.reference import ssm
from bench.harness.cell import load
from bench.tests.tiny import tiny

CPU = torch.device("cpu")
NAME = "mamba2-2.7b"
#: Codes that may differ between the program's moments and the
#: reference's after three steps, as a share of all codes.  In f32 the two
#: compute each moment entry to about 1e-6 of itself; a code differs only
#: where an entry lies that close to the midpoint between two levels (a
#: level is ~0.2 in log, so ~1e-5 of entries), and a differing code then
#: moves that entry's later steps, which may differ by a few levels where
#: the new gradient nearly cancels the old moment.  Four seeds read 8e-6
#: to 1.7e-5, each a single level.
FLIP_SHARE = 2e-4


def f32_cell(kind: str = "train"):
    c = tiny(f"{NAME}.{kind}")
    c.config.update(dtype="float32")
    return c


def program_model(cfg, params):
    prog = Program(cfg, CPU)
    paths = [s[0] for s in ssm.param_specs(cfg)]
    model = prog.model(lambda i: params[paths[i]].clone(), paths,
                       torch.float32)
    return prog, model


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_the_parameter_trees_agree():
    cfg = f32_cell().config
    prog, model = program_model(cfg, ssm.make_params(cfg, 3, CPU))
    specs = ssm.param_specs(cfg)
    assert [lf.path for lf in prog.leaves(model)] == [s[0] for s in specs]
    assert [lf.shape for lf in prog.leaves(model)] == [s[1] for s in specs]
    assert {p[:2] for p, _, _ in specs if p[0] == "layers"} == {
        ("layers", "norm1"), ("layers", "ssm")}
    assert len([p for p, _, _ in specs if p[1:2] == ("ssm",)]) == 8


def test_loss_and_gradients_match_the_program():
    from repro_torch.models import transformer as tfm

    c = f32_cell()
    cfg = c.config
    params = ssm.make_params(cfg, 11, CPU)
    prog, model = program_model(cfg, params)
    batch = c.traffic().Feed(c.mix, cfg, 11).batch(0, CPU)
    for t in model.parameters():
        t.requires_grad_(True)
    loss_p, _ = tfm.forward_train(prog.cfg, model, batch)
    loss_p.backward()
    with ssm.precision("f32"):
        for t in params.values():
            t.requires_grad_(True)
        loss_r = ssm.loss_fn(cfg, params, batch["tokens"], batch["labels"])
        loss_r.backward()
    assert float(loss_p.detach()) == pytest.approx(float(loss_r.detach()),
                                                   rel=1e-5)
    for lf in prog.leaves(model):
        want = params[lf.path].grad
        assert rel(lf.gather(lambda t: t.grad), want) < 1e-4, lf.path


@pytest.mark.parametrize("seed", [5, 2 ** 33 + 1])
def test_three_adamw_steps_with_8_bit_moments_match_the_program(seed):
    c = f32_cell()
    assert c.mix["optimizer"]["moments"] == "int8"
    run = c.runner().Run(c, seed, CPU)
    run.setup()
    leaves = run.program.leaves(run.state["params"])
    got = {lf.path: lf.gather().clone() for lf in leaves}
    codes = {"m": run.state["opt"]["m"], "v": run.state["opt"]["v"]}
    run.release()
    ref = run.reference()
    params = ssm.make_params(c.config, seed, CPU)
    batches = [(b["tokens"], b["labels"]) for b in
               (run.feed.batch(k, CPU) for k in range(3))]
    job = dict(c.mix["optimizer"], grad_accum=c.mix["grad_accum"])
    moments: dict = {}
    with ssm.precision("f32"):
        ssm.train(c.config, job, params, batches, moments)
    assert run.read["losses"] == pytest.approx(ref["losses"], rel=1e-5)
    for path, want in params.items():
        assert rel(got[path], want) < 1e-5, path
    flips = total = 0
    for kind in ("m", "v"):
        for q8, path in zip(codes[kind], params):
            mine = moments[kind][path]
            assert q8.q.shape == mine.codes.shape
            assert torch.allclose(q8.hi, mine.hi, rtol=0, atol=1e-4)
            flips += int((q8.q != mine.codes).sum())
            total += q8.q.numel()
    assert flips <= FLIP_SHARE * total, (flips, total)
    numbers = run.numbers(ref)
    assert numbers["grad_norm_gap"] < 1e-4
    assert numbers["update_norm_gap"] < 1e-3


def test_the_code_round_trips_within_one_level_and_keeps_zero():
    from repro_torch.training.optimizer import Quant8

    g = torch.Generator().manual_seed(4)
    x = torch.randn(3000, generator=g) * torch.exp(
        4 * torch.randn(3000, generator=g))
    x[::7] = 0.0
    x[5] = 1e-20                                  # below the code's floor
    codes, hi = ssm.encode(x, 256)
    assert codes.shape == (12, 256) and hi.shape == (12, 1)
    back = ssm.decode(codes, hi, x.numel())
    assert torch.equal(back[x == 0], x[x == 0]) and back[5] == 0
    kept = back != 0
    level = ((hi - ssm.LOG_TINY) / 127).expand(-1, 256).reshape(-1)[:3000]
    gap = (torch.log(back[kept].abs()) - torch.log(x[kept].abs())).abs()
    assert bool((gap <= level[kept] * 0.5 + 1e-5).all())
    assert torch.equal(torch.sign(back[kept]), torch.sign(x[kept]))
    # the definition written out is the program's code, bit for bit
    q8 = Quant8.encode(x, 256)
    assert torch.equal(q8.q, codes) and torch.equal(q8.hi, hi)
    assert torch.equal(q8.decode(), back)
    empty, hi0 = ssm.encode(torch.zeros(300), 256)
    assert not empty.any() and bool((hi0 == ssm.HI_FLOOR).all())


def test_the_mix_codes_the_moments_as_the_program():
    from repro_torch.training.optimizer import AdamWConfig

    mix = load(f"{NAME}.train").mix
    assert mix["optimizer"]["moments"] == "int8"
    assert mix["optimizer"]["moment_block"] == AdamWConfig().block


@pytest.mark.parametrize("length", [48, 160])
def test_prefill_state_matches_the_program(length):
    from repro_torch.serving import engine

    cfg = f32_cell("prefill").config
    params = ssm.make_params(cfg, 2, CPU)
    prog, model = program_model(cfg, params)
    tokens = torch.randint(0, cfg["vocab_size"], (3, length),
                           generator=torch.Generator().manual_seed(1))
    cap = length + 8
    state, logits = engine.prefill(prog.cfg, model, {"tokens": tokens}, cap)
    with ssm.precision("f32"):
        want, want_logits = ssm.prefill(cfg, params, tokens, cap)
    assert set(state) == set(want) == {"ssm", "conv", "pos"}
    assert state["pos"] == want["pos"] == length
    for k in ("ssm", "conv"):
        assert state[k].shape == want[k].shape, k
        assert rel(state[k], want[k]) < 1e-5, k
    assert rel(logits, want_logits) < 1e-5


def test_model_flops_per_token():
    cfg = load(f"{NAME}.train").config
    fwd = model_flops.model_flops(cfg, Pass(1, 4096, 4096, False)) / 4096
    assert fwd == pytest.approx(5.61e9, rel=0.01)
    assert model_flops.attention_flops(cfg, Pass(1, 4096, 4096, False)) == 0
    train = model_flops.model_flops(cfg, Pass(1, 4096, 4096, True)) / 4096
    assert train == pytest.approx(3 * fwd)


def test_k4_bounds_at_the_training_microbatch():
    # x (2, 4096, 80, 64), B / C (2, 4096, 1, 128): the products bind
    ms = 1e3
    assert k4_roofline.call_bound_s(2, 4096, 80, 64, 128, 1, H100_SXM) \
        * ms == pytest.approx(0.1640, abs=5e-5)
    assert k4bwd_roofline.call_bound_s(2, 4096, 80, 64, 128, 1, H100_SXM) \
        * ms == pytest.approx(0.3283, abs=5e-5)
    assert math.isclose(k4_roofline.call_bound_s(2, 4096, 80, 64, 128, 1,
                                                 H100_SXM),
                        k4_roofline.call_bound_s(4, 2048, 80, 64, 128, 1,
                                                 H100_SXM))

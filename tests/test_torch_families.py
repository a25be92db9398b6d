"""The port's LM families against the JAX reference, on the CPU.

Every architecture but hymba (``tests/test_torch_lm.py``): the reference's
``reduced()`` config (2 layers, d_model 128, f32) with the reference's own
initial parameters (``init_params(PRNGKey(0))``), carried into the port by
``convert.params_from_numpy``.  The same numpy tokens, patch embeddings and
frames go to both packages.

Tolerances (f32), as in tests/test_torch_lm.py: a block atol / rtol 1e-4
(the online softmax and the scan sum in another order than the reference's
jnp), the prefill's last-token logits, every state leaf and 4
teacher-forced decode steps atol / rtol 1e-4.

Two reference faults are pinned here (ROADMAP.md queue C):

* C15, command-r's decode ignores its parallel block: the port's decode
  equals the reference's full forward, the reference's decode does not.
* C16, whisper's decode attends to the zero padding of its cross-attention
  cache: with the cache exactly Se long the port equals the reference's
  decode; with a padded cache it equals the reference's full decoder pass,
  and the reference's decode does not.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.configs import base as r_base
from repro.models import transformer as r_tfm
from repro.models.common import ShardRules
from repro.serving import engine as r_engine
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import engine

RULES = ShardRules()
TOL = dict(atol=1e-4, rtol=1e-4)

# The reference's functions jitted with their config, rules and sizes
# static: one compile per case in place of an eager dispatch (and an
# interpreted Pallas call) per op.
R_INIT = jax.jit(r_tfm.init_params, static_argnums=0)
R_BLOCK = jax.jit(r_tfm.block_forward, static_argnums=(0, 1),
                  static_argnames=("causal",))
R_PREFILL = jax.jit(r_engine.prefill, static_argnums=(0, 3, 4))
R_PREFILL_AUDIO = jax.jit(r_engine.prefill_audio, static_argnums=(0, 3, 4))
R_DECODE = jax.jit(r_engine.decode_step, static_argnums=(0, 4))

NEW_ARCHS = [a for a in r_configs.ARCHS if a != "hymba-1.5b"]
#: Archs whose reference decode follows its own full forward.
DECODE_ARCHS = ["starcoder2-7b", "granite-20b", "qwen2.5-32b",
                "kimi-k2-1t-a32b", "granite-moe-1b-a400m",
                "phi-3-vision-4.2b", "mamba2-2.7b"]
B, S, N_DEC = 2, 40, 4

_MODELS: dict = {}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _model(arch):
    """(cfg, reference cfg, reference params, the port's Transformer)."""
    if arch not in _MODELS:
        cfg = configs.get(arch).reduced()
        r_cfg = r_configs.get(arch).reduced()
        params = R_INIT(r_cfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, params)
        _MODELS[arch] = (cfg, r_cfg, params, params_from_numpy(cfg, tree,
                                                               "cpu"))
    return _MODELS[arch]


def _tokens(cfg, seed=5, n=S + N_DEC):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, n))


def _patches(cfg, seed=6):
    return np.random.RandomState(seed).randn(
        B, cfg.n_patches, cfg.d_model).astype(np.float32)


def _frames(cfg, se, seed=7):
    return np.random.RandomState(seed).randn(B, se, cfg.d_model).astype(
        np.float32)


@pytest.mark.parametrize("arch", r_configs.ARCHS)
def test_configs_match_reference(arch):
    """Every field of the full and the reduced config, the parameter counts
    and the assigned shapes."""
    for make in ("make_config", "reduced"):
        got = getattr(configs.get(arch), make)()
        want = getattr(r_configs.get(arch), make)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want), make
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
    assert configs.shapes_for(arch) == r_configs.shapes_for(arch)
    assert configs.ARCHS == r_configs.ARCHS
    assert configs.SUBQUADRATIC == r_configs.SUBQUADRATIC


@pytest.mark.parametrize("arch", r_configs.ARCHS)
def test_input_specs_match_reference(arch):
    """``(shape, dtype)`` of every input of every assigned cell; the decode
    state's host ints are int32 scalars, the reference's ``pos`` is one."""
    cfg = configs.get(arch).make_config()
    r_cfg = r_configs.get(arch).make_config()
    for shape in configs.shapes_for(arch):
        got = base.input_specs(cfg, shape)
        want = r_base.input_specs(r_cfg, shape)
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        want_flat = {jax.tree_util.keystr(k): v for k, v in flat}
        got_flat = {}
        for top, inner in got.items():
            for name, spec in (inner.items() if isinstance(inner, dict)
                               else [(None, inner)]):
                key = f"['{top}']" + (f"['{name}']" if name else "")
                got_flat[key] = spec
        extra = set(got_flat) - set(want_flat)
        assert extra <= {"['state']['enc_len']"}, (shape, extra)
        for key, sds in want_flat.items():
            s, dt = got_flat[key]
            assert tuple(s) == tuple(sds.shape), (shape, key)
            assert str(dt).split(".")[-1] == str(sds.dtype), (shape, key)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_from_numpy_has_the_port_init_structure(arch):
    """The carried reference tree and the port's own random init build the
    same modules: parameter names, shapes and dtypes (dense weights
    transposed; the router and norms f32)."""
    cfg, _, _, port = _model(arch)
    own = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    got = {n: (t.shape, t.dtype) for n, t in own.named_parameters()}
    want = {n: (t.shape, t.dtype) for n, t in port.named_parameters()}
    assert got == want
    if cfg.family == "moe":
        bf16 = transformer.init_params(
            dataclasses.replace(cfg, dtype="bfloat16"),
            torch.Generator().manual_seed(0))
        assert bf16.layers[0].moe.router.weight.dtype == torch.float32
        assert bf16.layers[0].moe.wg.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_block_forward_matches_reference(arch):
    """Layer 0 on (2, 40, d) activations; whisper's is a decoder layer's
    self-attention block run as its encoder runs it (non-causal)."""
    cfg, r_cfg, params, port = _model(arch)
    x = np.random.RandomState(4).randn(B, S, cfg.d_model).astype(
        np.float32) * 0.5
    pos = np.arange(S)
    causal = cfg.family != "audio"
    fam_cfg = dataclasses.replace(cfg, family="dense") if not causal else cfg
    fam_r = dataclasses.replace(r_cfg, family="dense") if not causal \
        else r_cfg
    layer = jax.tree.map(lambda a: a[0], params["layers"])
    x_r, aux_r = R_BLOCK(fam_r, RULES, layer, jnp.asarray(x),
                         jnp.asarray(pos), causal=causal)
    x_t, aux = transformer.block_forward(fam_cfg, port.layers[0],
                                         torch.as_tensor(x),
                                         torch.as_tensor(pos), causal=causal)
    np.testing.assert_allclose(_np(x_t), _np(x_r), **TOL)
    for key in ("kv", "ssm"):
        if key in aux_r:
            for got, want in zip(aux[key], aux_r[key]):
                np.testing.assert_allclose(_np(got), _np(want), **TOL)
    if "moe_aux" in aux_r:
        np.testing.assert_allclose(float(aux["moe_aux"]),
                                   float(aux_r["moe_aux"]), rtol=1e-5)


def _prefill_both(arch, toks, cap):
    cfg, r_cfg, params, port = _model(arch)
    batch_r = {"tokens": jnp.asarray(toks)}
    batch = {"tokens": torch.as_tensor(toks)}
    if cfg.family == "vlm":
        p = _patches(cfg)
        batch_r["patch_embeds"] = jnp.asarray(p)
        batch["patch_embeds"] = torch.as_tensor(p)
    st_r, lg_r = R_PREFILL(r_cfg, params, batch_r, cap, RULES)
    st, lg = engine.prefill(cfg, port, batch, cap)
    return st_r, lg_r, st, lg


def _assert_states(st, st_r):
    names = [n for n in st_r if n != "pos"]
    assert sorted(set(st) - {"pos", "enc_len"}) == sorted(names)
    for name in names:
        assert tuple(st[name].shape) == tuple(st_r[name].shape), name
        np.testing.assert_allclose(_np(st[name]), _np(st_r[name]), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill of B = 2 prompts of 40 tokens (phi-3-vision: after 16 patch
    embeddings), then 4 teacher-forced decode steps: logits and every state
    leaf against the reference's engine."""
    cfg, r_cfg, params, port = _model(arch)
    toks = _tokens(cfg)
    n_pre = S + (cfg.n_patches if cfg.family == "vlm" else 0)
    cap = n_pre + N_DEC + 3
    st_r, lg_r, st, lg = _prefill_both(arch, toks[:, :S], cap)
    np.testing.assert_allclose(_np(lg), _np(lg_r), **TOL)
    assert st["pos"] == int(st_r["pos"]) == n_pre
    _assert_states(st, st_r)
    for t in range(S, S + N_DEC):
        tok = toks[:, t:t + 1]
        st_r, lg_r = R_DECODE(r_cfg, params, st_r, jnp.asarray(tok), RULES)
        st, lg = engine.decode_step(cfg, port, st, torch.as_tensor(tok))
        np.testing.assert_allclose(_np(lg), _np(lg_r), **TOL,
                                   err_msg=f"decode at {t}")
    _assert_states(st, st_r)


@functools.partial(jax.jit, static_argnums=0)
def _r_full_forward(r_cfg, params, toks):
    x = r_tfm.embed_tokens(r_cfg, params, toks)
    x, _ = r_tfm.run_stack(r_cfg, RULES, params["layers"], x,
                           jnp.arange(toks.shape[1]))
    return r_tfm.logits_from_x(r_cfg, params, x, RULES)


def _reference_full_logits(arch, toks):
    """Logits of every position from the reference's full forward
    (``run_stack`` + ``logits_from_x``)."""
    _, r_cfg, params, _ = _model(arch)
    return _np(_r_full_forward(r_cfg, params, jnp.asarray(toks)))


@functools.partial(jax.jit, static_argnums=0)
def _r_full_decoder(r_cfg, params, frames, toks):
    """The reference's full decoder pass: ``encode_audio`` + the decoder
    stack over every token, logits of every position."""
    enc = r_tfm.encode_audio(r_cfg, RULES, params, frames)
    x = r_tfm.embed_tokens(r_cfg, params, toks)
    x, _ = r_tfm._run_dec_stack_audio(r_cfg, RULES, params, x,
                                      jnp.arange(toks.shape[1]), enc)
    return r_tfm.logits_from_x(r_cfg, params, x, RULES)


def test_command_r_decode_runs_the_parallel_block():
    """C15: the port's prefill equals the reference's and its decode the
    reference's full forward at every step; the reference's own decode
    (serial attention then MLP) misses its full forward by far more."""
    arch = "command-r-35b"
    cfg, r_cfg, params, port = _model(arch)
    assert cfg.parallel_block
    toks = _tokens(cfg)
    full = _reference_full_logits(arch, toks)
    cap = S + N_DEC + 3
    st_r, lg_r, st, lg = _prefill_both(arch, toks[:, :S], cap)
    np.testing.assert_allclose(_np(lg), _np(lg_r), **TOL)
    _assert_states(st, st_r)
    ref_gap = 0.0
    for t in range(S, S + N_DEC):
        tok = toks[:, t:t + 1]
        st_r, lg_r = R_DECODE(r_cfg, params, st_r, jnp.asarray(tok), RULES)
        st, lg = engine.decode_step(cfg, port, st, torch.as_tensor(tok))
        np.testing.assert_allclose(_np(lg), full[:, t], **TOL,
                                   err_msg=f"decode at {t}")
        ref_gap = max(ref_gap, float(np.abs(_np(lg_r) - full[:, t]).max()))
    assert ref_gap > 1e-2, ref_gap


def _whisper_both(se, sd, cap):
    arch = "whisper-medium"
    cfg, r_cfg, params, port = _model(arch)
    frames = _frames(cfg, se)
    toks = _tokens(cfg, seed=8, n=sd + N_DEC)
    st_r, lg_r = R_PREFILL_AUDIO(
        r_cfg, params, {"frames": jnp.asarray(frames),
                        "tokens": jnp.asarray(toks[:, :sd])}, cap, RULES)
    st, lg = engine.prefill_audio(
        cfg, port, {"frames": torch.as_tensor(frames),
                    "tokens": torch.as_tensor(toks[:, :sd])}, cap)
    return frames, toks, st_r, lg_r, st, lg


def _whisper_decode(toks, sd, st_r, st):
    cfg, r_cfg, params, port = _model("whisper-medium")
    outs = []
    for t in range(sd, sd + N_DEC):
        tok = toks[:, t:t + 1]
        st_r, lg_r = R_DECODE(r_cfg, params, st_r, jnp.asarray(tok), RULES)
        st, lg = engine.decode_step(cfg, port, st, torch.as_tensor(tok))
        outs.append((_np(lg), _np(lg_r)))
    return st_r, st, outs


def test_whisper_prefill_and_decode_match_reference_when_cache_fits():
    """A cross cache exactly Se = 24 frames long (cap = 48): prefill_audio's
    logits and every state leaf, and 4 decode steps, equal the reference's
    (whose decode is right here)."""
    se, sd = 24, 12
    _, toks, st_r, lg_r, st, lg = _whisper_both(se, sd, cap=2 * se)
    np.testing.assert_allclose(_np(lg), _np(lg_r), **TOL)
    assert st["pos"] == sd and st["enc_len"] == se
    _assert_states(st, st_r)
    st_r, st, outs = _whisper_decode(toks, sd, st_r, st)
    for got, want in outs:
        np.testing.assert_allclose(got, want, **TOL)
    _assert_states(st, st_r)


def test_whisper_decode_masks_the_padded_cross_cache():
    """C16: cap = 512 packs Se = 24 frames into 256 cross slots.  The port's
    prefill still equals the reference's; its decode equals the reference's
    full decoder pass (encode_audio + the decoder stack) at every step,
    while the reference's decode, attending to the 232 zero slots, misses
    it by far more."""
    arch = "whisper-medium"
    cfg, r_cfg, params, port = _model(arch)
    se, sd = 24, 12
    frames, toks, st_r, lg_r, st, lg = _whisper_both(se, sd, cap=512)
    assert st["xk"].shape[3] == 256 and st["enc_len"] == se
    np.testing.assert_allclose(_np(lg), _np(lg_r), **TOL)
    _assert_states(st, st_r)
    full = _np(_r_full_decoder(r_cfg, params, jnp.asarray(frames),
                               jnp.asarray(toks)))
    _, _, outs = _whisper_decode(toks, sd, st_r, st)
    ref_gap = 0.0
    for i, (got, ref_dec) in enumerate(outs):
        np.testing.assert_allclose(got, full[:, sd + i], **TOL)
        ref_gap = max(ref_gap, float(np.abs(ref_dec - full[:, sd + i]).max()))
    assert ref_gap > 1e-2, ref_gap


def test_audio_prefill_raises_as_the_reference_does():
    cfg, _, _, port = _model("whisper-medium")
    with pytest.raises(NotImplementedError, match="prefill_audio"):
        engine.prefill(cfg, port, {"tokens": torch.zeros((1, 4),
                                                         dtype=torch.int64)},
                       16)


@pytest.mark.parametrize("arch", r_configs.ARCHS)
def test_serve_main_every_arch_on_cpu(arch):
    """The launcher on every reduced config (random init): vlm sends tokens
    only, audio raises as the reference's ``engine.prefill`` does."""
    argv = ["--device", "cpu", "--arch", arch, "--batch", "2",
            "--prompt-len", "12", "--gen", "3"]
    if arch == "whisper-medium":
        with pytest.raises(NotImplementedError):
            serve.main(argv)
        return
    out = serve.main(argv)
    assert out["tokens"].shape == (2, 3)
    assert out["cfg"].name == arch and out["cfg"].n_layers == 2
    assert int(out["tokens"].max()) < out["cfg"].vocab_size

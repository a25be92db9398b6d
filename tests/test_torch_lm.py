"""The port's hybrid LM (hymba) against the JAX reference, on the CPU.

Reduced hymba (``configs.get("hymba-1.5b").reduced()``: 2 layers, window
32, attn_block 64, f32) with the reference's own initial parameters,
carried into the port by ``convert.params_from_numpy``.  The same numpy
tokens and activations go to both packages.

Tolerances (f32): modules and block atol 1e-5 / rtol 1e-5 where the
arithmetic is the same products in another order; prefill logits and every
state leaf, and the logits of 40 teacher-forced decode steps, atol 1e-4 /
rtol 1e-4 (the scan and the online softmax sum in another order than the
reference's jnp).  The bf16 variant: logits atol 2e-2 (the attention
kernel's bf16 tolerance), and the same argmax wherever the reference's
top-2 margin exceeds 0.05.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import attention as r_attn
from repro.models import mlp as r_mlp
from repro.models import ssm as r_ssm
from repro.models import transformer as r_tfm
from repro.models.common import ShardRules
from repro.serving import engine as r_engine
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import attention, mlp, ssm, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import engine

RULES = ShardRules()
TOL = dict(atol=1e-4, rtol=1e-4)
TIGHT = dict(atol=1e-5, rtol=1e-5)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.fixture(scope="module")
def model():
    cfg = configs.get("hymba-1.5b").reduced()
    r_cfg = r_configs.get("hymba-1.5b").reduced()
    params = r_tfm.init_params(r_cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return cfg, r_cfg, params, tree, params_from_numpy(cfg, tree, "cpu")


def _layer(params, i):
    return jax.tree.map(lambda a: a[i], params["layers"])


def _x(cfg, b=2, s=96, seed=0):
    return np.random.RandomState(seed).randn(b, s, cfg.d_model).astype(
        np.float32)


def test_config_registry_matches_reference():
    full = configs.get("hymba-1.5b").make_config()
    r_full = r_configs.get("hymba-1.5b").make_config()
    for f in dataclasses.fields(full):
        assert getattr(full, f.name) == getattr(r_full, f.name), f.name
    assert full.param_count() == r_full.param_count()
    assert (full.n_layers, full.d_model, full.n_ssm_heads) == (32, 1600, 50)
    assert full.compute_dtype == torch.bfloat16
    red = configs.get("hymba-1.5b").reduced()
    assert dataclasses.asdict(red) == dataclasses.asdict(
        r_configs.get("hymba-1.5b").reduced())
    for arch in r_configs.ARCHS:
        if arch != "hymba-1.5b":
            with pytest.raises(NotImplementedError, match="not ported yet"):
                configs.get(arch)


def test_init_params_shapes_and_scales(model):
    """The port's own random init: the reference's shapes (dense weights
    transposed), dtypes and scales."""
    cfg, _, _, tree, _ = model
    p = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    carried = params_from_numpy(cfg, tree, "cpu")
    got = dict(p.named_parameters())
    want = dict(carried.named_parameters())
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert t.shape == want[name].shape and t.dtype == want[name].dtype, name
    np.testing.assert_allclose(float(p.embed.std()), 0.02, rtol=0.05)
    np.testing.assert_allclose(float(p.layers[0].ssm.conv_w.std()), 0.2,
                               rtol=0.1)
    o_scale = 0.02 / (2 * cfg.n_layers) ** 0.5
    np.testing.assert_allclose(float(p.layers[1].attn.wo.weight.std()),
                               o_scale, rtol=0.1)
    # log(linspace(1, 16, nh)): jnp's f32 linspace rounds a few points one
    # ulp apart from torch's (ROADMAP C.7).
    np.testing.assert_allclose(_np(p.layers[0].ssm.a_log),
                               tree["layers"]["ssm"]["a_log"][0], rtol=1e-6)


def test_qkv_and_attend_match_reference(model):
    cfg, r_cfg, params, _, port = model
    x = _x(cfg)
    pos = np.arange(x.shape[1])
    q_r, k_r, v_r = r_attn.qkv(r_cfg, _layer(params, 0)["attn"],
                               jnp.asarray(x), jnp.asarray(pos))
    q, k, v = attention.qkv(cfg, port.layers[0].attn, torch.as_tensor(x),
                            torch.as_tensor(pos))
    for got, want in ((q, q_r), (k, k_r), (v, v_r)):
        np.testing.assert_allclose(_np(got), _np(want), **TIGHT)
    for window in (None, cfg.window):
        got = attention.attend(cfg, q, k, v, window=window)
        want = r_attn.attend(r_cfg, q_r, k_r, v_r, window=window)
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s", [96, 40])
def test_ssm_apply_seq_matches_reference(model, s):
    """s = 96 pads the SSD to one 128-step chunk; s = 40 too."""
    cfg, r_cfg, params, _, port = model
    x = _x(cfg, s=s, seed=1)
    y_r, st_r = r_ssm.apply_seq(r_cfg, _layer(params, 1)["ssm"],
                                jnp.asarray(x))
    y, st = ssm.apply_seq(cfg, port.layers[1].ssm, torch.as_tensor(x))
    np.testing.assert_allclose(_np(y), _np(y_r), **TOL)
    np.testing.assert_allclose(_np(st.ssm), _np(st_r.ssm), **TOL)
    np.testing.assert_allclose(_np(st.conv), _np(st_r.conv), **TIGHT)


def test_ssm_apply_step_matches_reference(model):
    cfg, r_cfg, params, _, port = model
    rng = np.random.RandomState(2)
    x = rng.randn(2, 1, cfg.d_model).astype(np.float32)
    s0 = (rng.randn(2, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
          * 0.1).astype(np.float32)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    c0 = rng.randn(2, cfg.conv_width - 1, conv_dim).astype(np.float32)
    y_r, st_r = r_ssm.apply_step(r_cfg, _layer(params, 0)["ssm"],
                                 jnp.asarray(x),
                                 r_ssm.SSMState(jnp.asarray(s0),
                                                jnp.asarray(c0)))
    y, st = ssm.apply_step(cfg, port.layers[0].ssm, torch.as_tensor(x),
                           ssm.SSMState(torch.as_tensor(s0),
                                        torch.as_tensor(c0)))
    np.testing.assert_allclose(_np(y), _np(y_r), **TIGHT)
    np.testing.assert_allclose(_np(st.ssm), _np(st_r.ssm), **TIGHT)
    np.testing.assert_allclose(_np(st.conv), _np(st_r.conv), **TIGHT)


def test_mlp_matches_reference(model):
    cfg, r_cfg, params, _, port = model
    x = _x(cfg, s=8, seed=3)
    want = r_mlp.apply_dense(r_cfg, _layer(params, 0)["mlp"], jnp.asarray(x))
    got = mlp.apply_dense(cfg, port.layers[0].mlp, torch.as_tensor(x))
    np.testing.assert_allclose(_np(got), _np(want), **TIGHT)


@pytest.mark.parametrize("layer", [0, 1])
def test_block_forward_matches_reference(model, layer):
    """Layer 0 is global (no window), layer 1 slides a 32-token window;
    S = 96 > attn_block, so the reference takes its scan path."""
    cfg, r_cfg, params, _, port = model
    x = _x(cfg, seed=4) * 0.5
    pos = np.arange(x.shape[1])
    is_global = layer in cfg.global_layers
    x_r, aux_r = r_tfm.block_forward(r_cfg, RULES, _layer(params, layer),
                                     jnp.asarray(x), jnp.asarray(pos),
                                     is_global=jnp.asarray(is_global))
    x_t, aux = transformer.block_forward(cfg, port.layers[layer],
                                         torch.as_tensor(x),
                                         torch.as_tensor(pos),
                                         is_global=is_global)
    np.testing.assert_allclose(_np(x_t), _np(x_r), **TOL)
    np.testing.assert_allclose(_np(aux["kv"][0]), _np(aux_r["kv"][0]), **TIGHT)
    np.testing.assert_allclose(_np(aux["ssm"].ssm), _np(aux_r["ssm"].ssm),
                               **TOL)


def _tokens(cfg, b, s, seed=5):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s))


def test_prefill_and_40_decode_steps_match_reference(model):
    """B = 2, S = 96 (> window 32 and > attn_block 64, so the scan path and
    a padded SSD chunk), then 40 teacher-forced decode steps: the ring of
    width 32 wraps.  Logits and every state leaf against the reference."""
    cfg, r_cfg, params, _, port = model
    b, s, n_dec = 2, 96, 40
    toks = _tokens(cfg, b, s + n_dec)
    cap = s + n_dec + 8
    st_r, lg_r = r_engine.prefill(r_cfg, params,
                                  {"tokens": jnp.asarray(toks[:, :s])}, cap,
                                  RULES)
    st, lg = engine.prefill(cfg, port, {"tokens": torch.as_tensor(
        toks[:, :s])}, cap)
    np.testing.assert_allclose(_np(lg), _np(lg_r), **TOL)
    assert st["pos"] == int(st_r["pos"]) == s
    for name in ("ring_k", "ring_v", "glob_k", "glob_v", "ssm", "conv"):
        assert st[name].shape == st_r[name].shape, name
        np.testing.assert_allclose(_np(st[name]), _np(st_r[name]), **TOL,
                                   err_msg=name)

    step_r = jax.jit(lambda p, stt, t: r_engine.decode_step(r_cfg, p, stt, t,
                                                            RULES))
    for t in range(s, s + n_dec):
        st_r, lg_r = step_r(params, st_r, jnp.asarray(toks[:, t:t + 1]))
        st, lg = engine.decode_step(cfg, port, st,
                                    torch.as_tensor(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(lg), _np(lg_r), **TOL,
                                   err_msg=f"decode step at pos {t}")
    assert st["pos"] == s + n_dec
    for name in ("ring_k", "glob_v", "ssm", "conv"):
        np.testing.assert_allclose(_np(st[name]), _np(st_r[name]), **TOL,
                                   err_msg=name)


def test_params_from_numpy_runs_on_the_card_unless_asked(model,
                                                          monkeypatch):
    """The carrier's device is ``None`` -> the card, as every entry point:
    without a card it raises; ``device="cpu"`` carries the same weights and
    gives the reference's prefill logits."""
    cfg, r_cfg, params, tree, port = model
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params_from_numpy(cfg, tree)
    on_cpu = params_from_numpy(cfg, tree, device="cpu")
    assert on_cpu.embed.device.type == "cpu"
    toks = _tokens(cfg, 1, 40, seed=7)
    _, lg = engine.prefill(cfg, on_cpu, {"tokens": torch.as_tensor(toks)}, 48)
    _, lg_port = engine.prefill(cfg, port, {"tokens": torch.as_tensor(toks)},
                                48)
    _, lg_r = r_engine.prefill(r_cfg, params, {"tokens": jnp.asarray(toks)},
                               48, RULES)
    assert torch.equal(lg, lg_port)
    np.testing.assert_allclose(_np(lg), _np(lg_r), **TOL)


def test_bf16_prefill_and_decode_match_reference(model):
    """The reduced config in bf16: weights stored in bf16 by the carrier
    (the reference casts its f32 weights at use, the same values)."""
    _, _, params, tree, _ = model
    cfg = dataclasses.replace(configs.get("hymba-1.5b").reduced(),
                              dtype="bfloat16")
    r_cfg = dataclasses.replace(r_configs.get("hymba-1.5b").reduced(),
                                dtype="bfloat16")
    port = params_from_numpy(cfg, tree, "cpu")
    assert port.layers[0].attn.wq.weight.dtype == torch.bfloat16
    assert port.layers[0].ssm.conv_w.dtype == torch.float32
    b, s, n_dec = 2, 96, 4
    toks = _tokens(cfg, b, s + n_dec, seed=6)
    cap = s + n_dec + 8
    st_r, lg_r = r_engine.prefill(r_cfg, params,
                                  {"tokens": jnp.asarray(toks[:, :s])}, cap,
                                  RULES)
    st, lg = engine.prefill(cfg, port, {"tokens": torch.as_tensor(
        toks[:, :s])}, cap)
    outs = [(lg, lg_r)]
    for t in range(s, s + n_dec):
        st_r, lg_r = r_engine.decode_step(r_cfg, params, st_r,
                                          jnp.asarray(toks[:, t:t + 1]), RULES)
        st, lg = engine.decode_step(cfg, port, st,
                                    torch.as_tensor(toks[:, t:t + 1]))
        outs.append((lg, lg_r))
    for got, want in outs:
        assert got.dtype == torch.bfloat16
        g, w = _np(got), _np(want)
        np.testing.assert_allclose(g, w, atol=2e-2)
        top2 = np.sort(w, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 0.05
        np.testing.assert_array_equal(g.argmax(-1)[clear], w.argmax(-1)[clear])


def test_state_shapes_match_reference():
    cfg = configs.get("hymba-1.5b").reduced()
    r_cfg = r_configs.get("hymba-1.5b").reduced()
    shapes = engine.state_shapes(cfg, batch=2, cap=64)
    r_shapes = r_engine.state_shapes(r_cfg, batch=2, cap=64)
    assert set(shapes) | {"pos"} == set(r_shapes)
    for name, (shape, dtype) in shapes.items():
        assert shape == r_shapes[name].shape, name
        assert str(dtype).split(".")[-1] == str(r_shapes[name].dtype), name
    st = engine.init_state(cfg, 2, 64, "cpu")
    assert st["pos"] == 0 and all(
        bool((v == 0).all()) for k, v in st.items() if k != "pos")


def test_int8_cache_update_matches_reference():
    """The kv_dtype='int8' branch of cache_update: the reference's fixed
    scale of 16, truncated into int8, ring-aware."""
    rng = np.random.RandomState(7)
    k_new = (rng.randn(1, 2, 1, 8) * 3).astype(np.float32)
    v_new = (rng.randn(1, 2, 1, 8) * 3).astype(np.float32)
    r_cache = r_attn.KVCache.create(1, 2, 4, 8, jnp.int8, ring=True)
    r_cache = r_attn.cache_update(r_cache, jnp.asarray(k_new),
                                  jnp.asarray(v_new), 6)
    cache = attention.KVCache.create(1, 2, 4, 8, torch.int8, ring=True)
    cache = attention.cache_update(cache, torch.as_tensor(k_new),
                                   torch.as_tensor(v_new), 6)
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(r_cache.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(r_cache.v))


def test_ring_attend_decode_matches_reference():
    """A ring cache written past its width, read at several positions."""
    cfg = configs.get("hymba-1.5b").reduced()
    rng = np.random.RandomState(8)
    kc = rng.randn(1, 2, 8, 16).astype(np.float32)
    vc = rng.randn(1, 2, 8, 16).astype(np.float32)
    q = rng.randn(1, 4, 1, 16).astype(np.float32)
    for pos in (3, 7, 19):
        r_cache = r_attn.KVCache(jnp.asarray(kc), jnp.asarray(vc), ring=True)
        want = r_attn.attend_decode(cfg, jnp.asarray(q), r_cache,
                                    jnp.int32(pos), window=8)
        cache = attention.KVCache(torch.as_tensor(kc), torch.as_tensor(vc),
                                  ring=True)
        got = attention.attend_decode(cfg, torch.as_tensor(q), cache, pos,
                                      window=8)
        np.testing.assert_allclose(_np(got), _np(want), **TIGHT)


def test_serve_main_on_cpu():
    """The serve path end to end on the reduced config (random init)."""
    out = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "40",
                      "--gen", "5"])
    toks = out["tokens"]
    assert toks.shape == (2, 5)
    assert int(toks.min()) >= 0 and int(toks.max()) < out["cfg"].vocab_size
    assert out["prefill_s"] > 0 and out["decode_steps"] == 4


def test_serve_full_config_is_reachable():
    """--no-reduced selects the full hymba-1.5b (the reference's CLI cannot
    reach it), and the default device is the card."""
    ap = serve.build_parser()
    assert ap.parse_args([]).reduced
    assert not ap.parse_args(["--no-reduced"]).reduced
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--no-reduced"])

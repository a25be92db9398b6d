"""The plain versions of the port's LM kernels (K3 flash attention, K4 SSD
scan) against the reference's Pallas kernels, run in interpret mode as
tests/test_kernels_pallas.py runs them, and against its oracles.

The same numpy inputs go to both packages.  Tolerances are the reference
sweep's: attention 2e-5 in f32 and 2e-2 in bf16 (atol and rtol), SSD atol
1e-4.  The hand CUDA kernels themselves are held to these plain versions in
tests/test_torch_cuda.py (on a card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.models import ssm as r_ssm
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref
from repro_torch.models import ssm

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(a, dtype="float32"):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.as_tensor(np.asarray(a, np.float32)).to(td)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _qkv(seed, b, hq, hkv, sq, skv, dh, dtype="float32"):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hq, sq, dh)
    k = rng.randn(b, hkv, skv, dh)
    v = rng.randn(b, hkv, skv, dh)
    return [_both(a, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
def test_flash_attention_sweep(dtype, causal, window):
    """The reference sweep's shapes and inputs (b 2, hq 4, hkv 2, s 128)."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(3, 2, 4, 2, 128, 128, 32, dtype)
    tol = DTYPES[dtype][2]
    got = t_ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    pallas = r_ops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                   bq=64, bk=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    want = r_ref.attention(qj.astype(jnp.float32), kj.astype(jnp.float32),
                           vj.astype(jnp.float32), causal=causal,
                           window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("sq", [64, 100])
def test_flash_attention_ragged(sq):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(4, 1, 2, 2, sq, sq, 32)
    got = t_ops.flash_attention(qt, kt, vt)
    pallas = r_ops.flash_attention(qj, kj, vj, bq=64, bk=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(got), _np(r_ref.attention(qj, kj, vj)),
                               atol=2e-5)


@pytest.mark.parametrize("window", [None, 40])
def test_flash_attention_q_offset(window):
    """A query block placed at q_offset = 64 inside 160 keys (the decode /
    chunked-prefill case), causal, with and without a window."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(5, 1, 4, 2, 96, 160, 32)
    got = t_ops.flash_attention(qt, kt, vt, window=window, q_offset=64)
    pallas = r_ops.flash_attention(qj, kj, vj, window=window, q_offset=64,
                                   bq=64, bk=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=2e-5, rtol=2e-5)
    want = r_ref.attention(qj, kj, vj, window=window, q_offset=64)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_group_of_five(dtype):
    """hymba's GQA group 5 (not a power of two) at its head dim 64, over a
    window shorter than the sequence, so whole kv blocks are skipped."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(6, 1, 10, 2, 192, 192, 64, dtype)
    tol = DTYPES[dtype][2]
    got = t_ops.flash_attention(qt, kt, vt, window=48)
    pallas = r_ops.flash_attention(qj, kj, vj, window=48, bq=64, bk=64,
                                   interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
def test_attention_oracle_matches_reference(causal, window):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(7, 2, 4, 2, 80, 80, 32)
    got = ref.attention(qt, kt, vt, causal=causal, window=window)
    want = r_ref.attention(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def _ssd_inputs(seed, b, s, h, dh, g, ds, a_scale=0.3):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, dh) * 0.3
    a = -np.abs(rng.randn(b, s, h)) * a_scale
    bm = rng.randn(b, s, g, ds) * 0.3
    cm = rng.randn(b, s, g, ds) * 0.3
    return [_both(v) for v in (x, a, bm, cm)]


@pytest.mark.parametrize("s,chunk", [(128, 32), (256, 64), (256, 128)])
def test_ssd_sweep(s, chunk):
    """The reference sweep (b 2, h 4, dh 16, g 2, ds 8): the plain K4 in the
    model's layout against the Pallas kernel, which takes flattened heads
    with B and C repeated to every head, and against the sequential oracle."""
    b, h, dh, g, ds = 2, 4, 16, 2, 8
    (xj, xt), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(s + chunk, b, s, h,
                                                         dh, g, ds)
    y, s_fin = t_ops.ssd_scan(xt, at, bt, ct, chunk=chunk)
    rep = h // g
    xf = jnp.moveaxis(xj, 2, 1).reshape(b * h, s, dh)
    af = jnp.moveaxis(aj, 2, 1).reshape(b * h, s)
    bf = jnp.moveaxis(jnp.repeat(bj, rep, 2), 2, 1).reshape(b * h, s, ds)
    cf = jnp.moveaxis(jnp.repeat(cj, rep, 2), 2, 1).reshape(b * h, s, ds)
    y_p, s_p = r_ops.ssd_scan(xf, af, bf, cf, chunk=chunk, interpret=True)
    y_p = jnp.moveaxis(y_p.reshape(b, h, s, dh), 1, 2)
    np.testing.assert_allclose(_np(y), _np(y_p), atol=1e-4)
    np.testing.assert_allclose(_np(s_fin), _np(s_p.reshape(b, h, dh, ds)),
                               atol=1e-4)
    y_r, s_r = r_ref.ssd(xj, aj, bj, cj)
    np.testing.assert_allclose(_np(y), _np(y_r), atol=1e-4)
    np.testing.assert_allclose(_np(s_fin), _np(s_r), atol=1e-4)


def test_ssd_oracle_matches_reference():
    (xj, xt), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(9, 1, 64, 4, 8, 2, 8)
    y, s_fin = ref.ssd(xt, at, bt, ct)
    y_r, s_r = r_ref.ssd(xj, aj, bj, cj)
    np.testing.assert_allclose(_np(y), _np(y_r), atol=1e-5)
    np.testing.assert_allclose(_np(s_fin), _np(s_r), atol=1e-5)


def test_ssd_hymba_head_shape():
    """hymba's SSM heads (dh 64, one group of ds 16 shared by every head) at
    the model's chunk of 128: the plain K4 against the sequential oracle."""
    (xj, xt), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(10, 1, 256, 5, 64,
                                                         1, 16)
    y, s_fin = t_ops.ssd_scan(xt, at, bt, ct, chunk=128)
    y_r, s_r = r_ref.ssd(xj, aj, bj, cj)
    np.testing.assert_allclose(_np(y), _np(y_r), atol=1e-4)
    np.testing.assert_allclose(_np(s_fin), _np(s_r), atol=1e-4)


@pytest.mark.parametrize("s,chunk", [(100, 32), (192, 128)])
def test_ssd_padded_sequence(s, chunk):
    """s % chunk != 0: ``ssm.ssd_chunked`` pads with zeros, which decays by
    exp(0) = 1 and adds nothing, so y and the final state handed to decode
    equal the unpadded sequential scan's; and they equal the reference's
    ``ssd_chunked``."""
    (xj, xt), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(s, 1, s, 2, 8, 1, 16,
                                                         a_scale=0.2)
    y, s_fin = ssm.ssd_chunked(xt, at, bt, ct, chunk=chunk)
    assert y.shape == (1, s, 2, 8)
    y_r, s_r = r_ref.ssd(xj, aj, bj, cj)
    np.testing.assert_allclose(_np(y), _np(y_r), atol=1e-4)
    np.testing.assert_allclose(_np(s_fin), _np(s_r), atol=1e-4)
    y_c, s_c = r_ssm.ssd_chunked(xj, aj, bj, cj, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(y_c), atol=1e-4)
    np.testing.assert_allclose(_np(s_fin), _np(s_c), atol=1e-4)


def test_kernel_wrappers_refuse_what_they_cannot_launch():
    """A CPU tensor never reaches K3 / K4 (the ops run the plain versions);
    the CUDA wrappers refuse it, and other devices raise in the ops."""
    from repro_torch.kernels import flash_attention, ssd

    q = torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(q, q, q)
    x = torch.zeros((1, 32, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_cuda(x, x[..., 0], x[:, :, :1], x[:, :, :1], chunk=32)
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_scan_cuda(x, x[..., 0], x[:, :, :1], x[:, :, :1], chunk=48)
    meta = torch.empty((1, 2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_ops.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="not a multiple"):
        t_ops.ssd_scan(x[:, :30], x[:, :30, :, 0], x[:, :30, :1],
                     x[:, :30, :1], chunk=32)

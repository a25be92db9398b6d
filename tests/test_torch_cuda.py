"""The port's hand CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU (a CUDA kernel has no CPU mode): they carry the
``cuda`` marker and skip without a card.  Run them on one with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the reference package, so it runs where
only the port is installed.  Tolerances are those of
tests/test_torch_kernels.py (K1: atol max(5e-6, 2e-6 gamma), rtol 1e-5;
K2) and tests/test_torch_lm_kernels.py (K3: 2e-5 in f32, 2e-2 in bf16, at
every head dim the configs use, 32 to 128; K4 and each of its passes: atol
1e-4, at state widths up to 128).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, rbf, ref, solver, ssd


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _lanes(seed, p, n, d, g, l, c_hi=5.0):
    rng = np.random.RandomState(seed)
    x = rng.rand(p, n, d).astype(np.float32)
    y = np.where(rng.rand(p, n) > 0.5, 1.0, -1.0).astype(np.float32)
    c_box = (rng.rand(p, l, n) * c_hi * (rng.rand(p, l, n) > 0.2)
             ).astype(np.float32)
    gamma = (rng.rand(p, g) * 6.0 + 0.3).astype(np.float32)
    return x, y, c_box, gamma


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rbf", "sech2"])
def test_k1_kernel_matches_plain(card, kind):
    rng = np.random.RandomState(0)
    x = _t(rng.rand(97, 5)).to(card)
    sv = _t(rng.rand(3, 130, 5)).to(card)
    gamma = _t([0.1, 1.0, 30.0]).to(card)
    got = rbf.kernel_matrix_cuda(x, sv, gamma, kind, v_scale=1.0)
    want = rbf.kernel_matrix_plain(x, sv, gamma, kind, v_scale=1.0)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=6e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rbf", "sech2"])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 7])
@pytest.mark.parametrize("n,m,p", [(97, 130, 3), (1, 1, 1), (70, 128, 66),
                                   (129, 257, 1)])
def test_k1_ragged_edges_and_widths(card, kind, d, n, m, p):
    """Rows and columns that do not fill the 64 x 128 tile, every d the
    kernel unrolls (1-5) and one it reads in place (7), and m allowing
    float4 (128), float2 (130) or only scalar (1, 257) stores."""
    rng = np.random.RandomState(n + m + p + d)
    x = _t(rng.rand(n, d)).to(card)
    sv = _t(rng.rand(p, m, d)).to(card)
    gamma = _t(rng.rand(p) * 30.0 + 0.1).to(card)
    got = rbf.kernel_matrix_cuda(x, sv, gamma, kind, v_scale=1.0)
    want = rbf.kernel_matrix_plain(x, sv, gamma, kind, v_scale=1.0)
    torch.cuda.synchronize()
    atol = max(5e-6, 2e-6 * float(gamma.max()))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=atol, rtol=1e-5)


@pytest.mark.cuda
def test_k1_sech2_at_wide_rows_where_a_query_is_a_support_vector(card):
    """d = 64, read in place: where a query equals a support vector every
    factor is 1, so the value is 1, not the NaN of inf / inf that products
    of 4^d would give."""
    rng = np.random.RandomState(64)
    sv = _t(rng.rand(2, 9, 64)).to(card)
    x = torch.cat([sv[0, :4], _t(rng.rand(3, 64)).to(card)]).contiguous()
    gamma = _t([0.5, 4.0]).to(card)
    got = rbf.kernel_matrix_cuda(x, sv, gamma, "sech2", v_scale=1.0)
    want = rbf.kernel_matrix_plain(x, sv, gamma, "sech2", v_scale=1.0)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got[0, range(4), range(4)] == 1.0).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=max(5e-6, 2e-6 * 4.0), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "rbf", "sech2", "gram"])
def test_k2_kernel_matches_plain(card, kind):
    x, y, c_box, gamma = (_t(a).to(card) for a in _lanes(3, 2, 45, 3, 2, 3))
    if kind == "gram":
        kp = ref.lane_grams(x, gamma, "rbf")
        a, f = solver.solve_lanes_gram_cuda(kp, y, c_box, 20)
        a_p, f_p = ref.solve_lanes_gram(kp, y, c_box, 20)
    else:
        a, f = solver.solve_lanes_cuda(x, y, c_box, gamma, kind, 20)
        a_p, f_p = ref.solve_lanes(x, y, c_box, gamma, kind, 20)
    torch.cuda.synchronize()
    np.testing.assert_allclose(a.cpu().numpy(), a_p.cpu().numpy(),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(f.cpu().numpy(), f_p.cpu().numpy(),
                               atol=5e-3, rtol=1e-3)
    assert (a[c_box[:, None].expand_as(a) == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "rbf", "sech2", "gram"])
def test_k2_har12_width_dynamic_shared_memory(card, kind):
    """n = 1582, d = 5: the lane state exceeds the 48 KB default, so the
    launch raises the block's dynamic shared-memory limit; the K' slabs
    span four column chunks."""
    x, y, c_box, gamma = (_t(a).to(card)
                          for a in _lanes(5, 1, 1582, 5, 1, 2))
    if kind == "gram":
        kp = ref.lane_grams(x, gamma, "rbf").contiguous()
        a, f = solver.solve_lanes_gram_cuda(kp, y, c_box, 2)
        a_p, f_p = ref.solve_lanes_gram(kp, y, c_box, 2)
    else:
        a, f = solver.solve_lanes_cuda(x, y, c_box, gamma, kind, 2)
        a_p, f_p = ref.solve_lanes(x, y, c_box, gamma, kind, 2)
    torch.cuda.synchronize()
    assert (a[c_box[:, None].expand_as(a) == 0] == 0).all()
    np.testing.assert_allclose(a.cpu().numpy(), a_p.cpu().numpy(),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(f.cpu().numpy(), f_p.cpu().numpy(),
                               atol=5e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "rbf", "sech2", "gram"])
@pytest.mark.parametrize("p,g,l", [(3, 7, 35), (1, 1, 3), (2, 3, 5)])
def test_k2_lane_groups_that_do_not_fill_a_cta(card, kind, p, g, l):
    """Lane counts that leave the last CTA of a (pair, gamma) cell short
    (balance's (3, 7, 35): 6 CTAs of 6, 6, 6, 6, 6 and 5 lanes), n = 45
    (not a multiple of 16), rows with c_box = 0 exactly 0."""
    x, y, c_box, gamma = (_t(a).to(card) for a in _lanes(7, p, 45, 4, g, l))
    if kind == "gram":
        kp = ref.lane_grams(x, gamma, "rbf").contiguous()
        a, f = solver.solve_lanes_gram_cuda(kp, y, c_box, 10)
        a_p, f_p = ref.solve_lanes_gram(kp, y, c_box, 10)
    else:
        a, f = solver.solve_lanes_cuda(x, y, c_box, gamma, kind, 10)
        a_p, f_p = ref.solve_lanes(x, y, c_box, gamma, kind, 10)
    torch.cuda.synchronize()
    np.testing.assert_allclose(a.cpu().numpy(), a_p.cpu().numpy(),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(f.cpu().numpy(), f_p.cpu().numpy(),
                               atol=5e-3, rtol=1e-3)
    assert (a[c_box[:, None].expand_as(a) == 0] == 0).all()


def _qkv(seed, b, hq, hkv, sq, skv, dh, dtype, dev):
    rng = np.random.RandomState(seed)
    return [torch.as_tensor(rng.randn(*shape), dtype=torch.float32)
            .to(device=dev, dtype=dtype)
            for shape in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_k3_kernel_matches_plain(card, dtype, causal, window, dh):
    q, k, v = _qkv(3, 2, 10, 2, 200, 200, dh, dtype, card)
    got = flash_attention.flash_attention_cuda(q, k, v, causal, window)
    want = ref.flash_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [64, 100])
def test_k3_ragged_and_q_offset(card, sq):
    q, k, v = _qkv(4, 1, 4, 2, sq, sq, 32, torch.float32, card)
    got = flash_attention.flash_attention_cuda(q, k, v)
    np.testing.assert_allclose(got.cpu().numpy(),
                               ref.attention(q, k, v).cpu().numpy(), atol=2e-5)
    q, k, v = _qkv(5, 1, 4, 2, sq, sq + 70, 32, torch.float32, card)
    got = flash_attention.flash_attention_cuda(q, k, v, window=40, q_offset=70)
    want = ref.flash_attention(q, k, v, window=40, q_offset=70)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("q_offset", [0, 37])
@pytest.mark.parametrize("sq", [64, 100, 200])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_k3_tensor_core_kernel_matches_plain(card, dh, causal, window, sq,
                                             q_offset):
    """bf16 through the wgmma / TMA kernel: GQA group 5, ragged sq (TMA
    zero-fills past the end; the masks still decide), a q block offset in
    the kv sequence.  Tolerance 2e-2, the reference's bf16 sweep."""
    q, k, v = _qkv(6, 2, 10, 2, sq, sq + q_offset, dh, torch.bfloat16, card)
    before = (flash_attention.LAUNCHES_TC.count,
              flash_attention.LAUNCHES_F32.count)
    got = flash_attention.flash_attention_cuda(q, k, v, causal, window,
                                               q_offset)
    want = ref.flash_attention(q, k, v, causal, window, q_offset)
    torch.cuda.synchronize()
    assert (flash_attention.LAUNCHES_TC.count,
            flash_attention.LAUNCHES_F32.count) == (before[0] + 1, before[1])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_k3_tensor_core_kernel_fails_with_a_narrowed_window(card):
    """Negative control: the tensor-core kernel run with its window narrowed
    by one kv block (64 keys) must fail the 2e-2 check it passes above."""
    q, k, v = _qkv(8, 1, 5, 1, 512, 512, 64, torch.bfloat16, card)
    got = flash_attention.flash_attention_cuda(q, k, v, True, 256 - 64)
    want = ref.flash_attention(q, k, v, True, 256)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    assert not bool((err <= 2e-2 + 2e-2 * want.float().abs()).all())


def _ssd(seed, b, s, h, dh, g, ds, dev):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, dh) * 0.3
    a = -np.abs(rng.randn(b, s, h)) * 0.3
    bm = rng.randn(b, s, g, ds) * 0.3
    cm = rng.randn(b, s, g, ds) * 0.3
    return [_t(t).to(dev) for t in (x, a, bm, cm)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,chunk", [(128, 32), (256, 64), (256, 128)])
@pytest.mark.parametrize("dh,g,ds", [(16, 2, 8), (64, 1, 16)])
def test_k4_kernel_matches_plain(card, s, chunk, dh, g, ds):
    x, a, bm, cm = _ssd(s + chunk, 2, s, 4, dh, g, ds, card)
    y, s_fin = ssd.ssd_scan_cuda(x, a, bm, cm, chunk)
    y_p, s_p = ref.ssd_scan(x, a, bm, cm, chunk)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.cpu().numpy(), y_p.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(s_fin.cpu().numpy(), s_p.cpu().numpy(),
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("a_scale", [0.3, 3.0])
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("g", [1, 2])
def test_k4_sixteen_chunks(card, a_scale, dh, g):
    """s = 2048 at the model's chunk of 128: 16 chunks whose states the
    state pass carries, with a mild decay and a strong one (exp(cum)
    underflows within a chunk)."""
    rng = np.random.RandomState(int(a_scale * 10) + dh + g)
    b, s, h, ds = 2, 2048, 4, 16
    x = rng.randn(b, s, h, dh) * 0.3
    a = -np.abs(rng.randn(b, s, h)) * a_scale
    bm, cm = (rng.randn(b, s, g, ds) * 0.3 for _ in range(2))
    x, a, bm, cm = (_t(t).to(card) for t in (x, a, bm, cm))
    y, s_fin = ssd.ssd_scan_cuda(x, a, bm, cm, 128)
    y_p, s_p = ref.ssd_scan(x, a, bm, cm, 128)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.cpu().numpy(), y_p.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(s_fin.cpu().numpy(), s_p.cpu().numpy(),
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,g,ds", [(64, 1, 16), (16, 2, 8), (64, 2, 5),
                                     (16, 1, 24), (64, 1, 64)])
def test_k4_passes_match_their_plain_twins(card, dh, g, ds):
    """Each device pass against its plain twin on the kernel's own inputs
    to it, at state widths the kernel pads (5, 24) and its widest (64)."""
    x, a, bm, cm = _ssd(ds, 2, 512, 4, dh, g, ds, card)
    _, _, cum1, ds1 = ssd.ssd_passes_cuda(x, a, bm, cm, 128,
                                           chunk_states_only=True)
    y, s_fin, cum, s_prev = ssd.ssd_passes_cuda(x, a, bm, cm, 128)
    cum_p, ds_p = ref.ssd_chunk_states(x, a, bm, 128)
    s_prev_p, s_fin_p = ref.ssd_state_pass(cum1, ds1, 128)
    y_p = ref.ssd_chunk_scan(x, bm, cm, cum, s_prev, 128)
    y_r, s_r = ref.ssd_scan(x, a, bm, cm, 128)
    torch.cuda.synchronize()
    for got, want in ((cum1, cum_p), (ds1, ds_p), (s_prev, s_prev_p),
                      (s_fin, s_fin_p), (y, y_p), (y, y_r), (s_fin, s_r)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-4)


@pytest.mark.cuda
def test_k4_three_device_launches_per_call(card):
    """One ``ssd_scan_cuda`` call is ``ssd.DEVICE_LAUNCHES`` device kernels,
    all named ``ssd_*`` (the trace's K4 group), and one counted launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, a, bm, cm = _ssd(3, 1, 256, 4, 64, 1, 16, card)
    ssd.ssd_scan_cuda(x, a, bm, cm, 128)
    torch.cuda.synchronize()
    before = ssd.LAUNCHES.count
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ssd.ssd_scan_cuda(x, a, bm, cm, 128)
        torch.cuda.synchronize()
    names = sorted(e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    assert len(names) == ssd.DEVICE_LAUNCHES == 3, names
    assert all("ssd_" in n for n in names), names
    assert ssd.LAUNCHES.count == before + 1


@pytest.mark.cuda
def test_k4_padded_sequence(card):
    """A sequence padded with zeros (through ``ssm.ssd_chunked``) whose y
    and final state equal the sequential oracle's on the unpadded one."""
    from repro_torch.models import ssm as ssm_mod

    x, a, bm, cm = _ssd(9, 1, 128, 4, 64, 1, 16, card)
    n = 100
    y, s_fin = ssm_mod.ssd_chunked(x[:, :n], a[:, :n], bm[:, :n], cm[:, :n],
                                   chunk=32)
    y_r, s_r = ref.ssd(x[:, :n], a[:, :n], bm[:, :n], cm[:, :n])
    np.testing.assert_allclose(y.cpu().numpy(), y_r.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(s_fin.cpu().numpy(), s_r.cpu().numpy(),
                               atol=1e-4)


@pytest.mark.cuda
def test_reduced_hymba_prefill_card_matches_cpu(card):
    """The reduced hymba prefill through K3 and K4 on the card against the
    plain versions on the CPU, same weights: logits atol 1e-4."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import engine

    cfg = configs.get("hymba-1.5b").reduced()
    host = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    on_card = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    on_card.to(card)
    toks = torch.as_tensor(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 96)))
    ops.reset_launches()
    st_c, lg_c = engine.prefill(cfg, on_card, {"tokens": toks.to(card)}, 120)
    counts = ops.launch_counts()
    st_h, lg_h = engine.prefill(cfg, host, {"tokens": toks}, 120)
    assert counts["flash_attention"] == counts["ssd"] == cfg.n_layers
    np.testing.assert_allclose(lg_c.cpu().numpy(), lg_h.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(st_c["ssm"].cpu().numpy(), st_h["ssm"].numpy(),
                               atol=1e-4, rtol=1e-4)



# -- the other LM families: K3 at dh 96 / 112 and across lengths, K4 at ds 128 ---


@pytest.mark.cuda
@pytest.mark.parametrize("q_offset", [0, 37])
@pytest.mark.parametrize("sq", [64, 100, 200])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [96, 112])
def test_k3_phi3_and_kimi_head_dims_match_plain(card, dh, dtype, causal,
                                                window, sq, q_offset):
    """phi-3-vision's dh 96 (32-column atoms, 64 B swizzle, m64n96) and
    kimi-k2's dh 112 (16-column atoms, 32 B swizzle, m64n112) with a GQA
    group of 8, every mask, ragged sq and a q block offset; f32 through the
    CUDA-core kernel.  Tolerances 2e-5 (f32) and 2e-2 (bf16)."""
    q, k, v = _qkv(20 + dh, 1, 8, 1, sq, sq + q_offset, dh, dtype, card)
    variant = (flash_attention.LAUNCHES_TC if dtype == torch.bfloat16
               else flash_attention.LAUNCHES_F32)
    before = variant.count
    got = flash_attention.flash_attention_cuda(q, k, v, causal, window,
                                               q_offset)
    want = ref.flash_attention(q, k, v, causal, window, q_offset)
    torch.cuda.synchronize()
    assert variant.count == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 96, 112])
def test_k3_cross_attention_lengths_match_plain(card, dh, dtype):
    """Non-causal with sq != skv, as whisper's cross-attention runs it: 64
    decoder queries against 1500 encoder keys (a ragged last kv block)."""
    q, k, v = _qkv(30 + dh, 2, 8, 8, 64, 1500, dh, dtype, card)
    got = flash_attention.flash_attention_cuda(q, k, v, causal=False)
    want = ref.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("a_scale", [0.3, 3.0])
@pytest.mark.parametrize("g", [1, 2])
def test_k4_mamba2_state_width_passes_match_plain(card, g, a_scale):
    """mamba2's ssm_state 128 at dh 64, chunk 128, over 4 chunks, with a
    mild and a strong decay: y and the final state against the plain K4,
    and each pass against its plain twin on the kernel's own inputs to it
    (atol 1e-4; pass 1's cumsum, which reaches -300 with the strong decay,
    also rtol 1e-5, as chip_smoke.py's phase 5 holds it)."""
    rng = np.random.RandomState(40 + g + int(a_scale * 10))
    b, s, h, dh, ds = 2, 512, 4, 64, 128
    x = rng.randn(b, s, h, dh) * 0.3
    a = -np.abs(rng.randn(b, s, h)) * a_scale
    bm, cm = (rng.randn(b, s, g, ds) * 0.3 for _ in range(2))
    x, a, bm, cm = (_t(t).to(card) for t in (x, a, bm, cm))
    _, _, cum1, ds1 = ssd.ssd_passes_cuda(x, a, bm, cm, 128,
                                           chunk_states_only=True)
    y, s_fin, cum, s_prev = ssd.ssd_passes_cuda(x, a, bm, cm, 128)
    cum_p, ds_p = ref.ssd_chunk_states(x, a, bm, 128)
    s_prev_p, s_fin_p = ref.ssd_state_pass(cum1, ds1, 128)
    y_p = ref.ssd_chunk_scan(x, bm, cm, cum, s_prev, 128)
    y_r, s_r = ref.ssd_scan(x, a, bm, cm, 128)
    torch.cuda.synchronize()
    np.testing.assert_allclose(cum1.cpu().numpy(), cum_p.cpu().numpy(),
                               atol=1e-4, rtol=1e-5)
    for got, want in ((ds1, ds_p), (s_prev, s_prev_p), (s_fin, s_fin_p),
                      (y, y_p), (y, y_r), (s_fin, s_r)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["starcoder2-7b", "granite-20b",
                                  "qwen2.5-32b", "command-r-35b",
                                  "kimi-k2-1t-a32b", "granite-moe-1b-a400m",
                                  "phi-3-vision-4.2b", "mamba2-2.7b",
                                  "whisper-medium"])
def test_reduced_family_prefill_card_matches_cpu(card, arch):
    """Each other family's reduced prefill (f32) on the card through K3 / K4
    against the plain versions on the CPU, same weights: last-token logits
    atol 1e-4; then 3 decode steps on both, logits atol 1e-4, which launch
    neither kernel."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import engine

    cfg = configs.get(arch).reduced()
    host = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    on_card = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    on_card.to(card)
    rng = np.random.RandomState(3)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (2, 100)))
    batch = {"tokens": toks[:, :96]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = _t(rng.randn(2, cfg.n_patches, cfg.d_model))
    if cfg.family == "audio":
        batch["frames"] = _t(rng.randn(2, 150, cfg.d_model))
        run = engine.prefill_audio
        cap = 1024          # 128 decoder slots, 512 cross slots (150 used)
    else:
        run = engine.prefill
        cap = 96 + cfg.n_patches + 8
    ops.reset_launches()
    st_c, lg_c = run(cfg, on_card, {n: t.to(card) for n, t in batch.items()},
                     cap)
    counts = ops.launch_counts()
    st_h, lg_h = run(cfg, host, batch, cap)
    n_attn = {"ssm": 0, "audio": cfg.n_enc_layers + 2 * cfg.n_layers}.get(
        cfg.family, cfg.n_layers)
    assert counts["flash_attention"] == n_attn
    assert counts["ssd"] == (cfg.n_layers if cfg.family == "ssm" else 0)
    np.testing.assert_allclose(lg_c.cpu().numpy(), lg_h.numpy(), atol=1e-4,
                               rtol=1e-4)
    ops.reset_launches()
    for t in range(96, 99):
        _, lg_c = engine.decode_step(cfg, on_card, st_c, toks[:, t:t + 1].to(
            card))
        _, lg_h = engine.decode_step(cfg, host, st_h, toks[:, t:t + 1])
        np.testing.assert_allclose(lg_c.cpu().numpy(), lg_h.numpy(),
                                   atol=1e-4, rtol=1e-4)
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.launch_counts()["ssd"] == 0

# -- the design space and Monte-Carlo paths on the card ---------------------------
#
# No hand kernel runs here (the analog candidates are measured-curve
# banks); these hold the card to the CPU where the port promises bit
# identity, and the streaming engine's memory to one chunk.


def _tiny_candidates(k=3, m=6, d=3, seed=0):
    """Per-pair (digital linear, analog) candidates around the port's
    default core."""
    from repro_torch.core import analog, ovo, svm, trainer

    hw = trainer.default_hw(0)
    gamma = float(trainer.hw_gamma_grid(hw)[3])
    rng = np.random.RandomState(seed)
    cands = []
    for _ in ovo.class_pairs(k):
        w = rng.randn(d)
        lin = svm.SVMModel(kind="linear", support_x=np.zeros((1, d)),
                           support_y=np.ones(1), alpha=np.zeros(1),
                           bias=float(-w.sum() / 2), gamma=1.0, c=1.0, w=w)
        rbf = svm.SVMModel(kind="hw", support_x=rng.rand(m, d),
                           support_y=np.where(rng.rand(m) > 0.5, 1.0, -1.0),
                           alpha=rng.rand(m) + 0.1,
                           bias=float(rng.randn() * 0.1), gamma=gamma, c=1.0,
                           kernel_fn=hw.kernel_response)
        cands.append((ovo.DigitalLinearClassifier.deploy(lin),
                      analog.AnalogBinaryClassifier.deploy(rbf, hw)))
    return cands


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(3, 188), (5, 400), (12, 400)])
def test_recombination_card_equals_cpu_bit_for_bit(card, k, n):
    """Accuracies are integer counts: the card's recombination (encoder
    table up to P = 12, votes at P = 66) equals the CPU's exactly, over
    the variant axis too."""
    from repro_torch.core import dse

    rng = np.random.RandomState(k)
    p = k * (k - 1) // 2
    bits = rng.randint(0, 2, (n, p, 2)).astype(np.int32)
    bits3 = rng.randint(0, 2, (4, n, p, 2)).astype(np.int32)
    y = rng.randint(0, k, n)
    a = dse.enumerate_assignments(p) if p <= 10 else rng.rand(300, p) < 0.5
    for fn, b in ((dse.assignment_accuracies, bits),
                  (dse.assignment_accuracies_mc, bits3)):
        np.testing.assert_array_equal(fn(b, a, y, k, device=card),
                                      fn(b, a, y, k, device="cpu"))
    if p <= 12:
        np.testing.assert_array_equal(
            dse.assignment_accuracies(bits, a, y, k, max_table_bits=0,
                                      device=card),
            dse.assignment_accuracies(bits, a, y, k, device="cpu"))


@pytest.mark.cuda
def test_votes_argmax_tie_on_card_is_lowest_index(card):
    from repro_torch.core import dse

    cyc = np.array([[1, 0, 1]], np.int32)       # every class one vote
    bits = np.stack([cyc, 0 * cyc], axis=-1).repeat(4, axis=0)
    a = np.array([[0, 0, 0], [1, 1, 1]], bool)
    got = dse.assignment_accuracies(bits, a, np.array([0, 1, 2, 0]), 3,
                                    max_table_bits=0, device=card)
    np.testing.assert_array_equal(got, [0.5, 0.25])


@pytest.mark.cuda
def test_design_space_on_card_matches_cpu(card):
    from repro_torch.core import dse, hwcost

    cands = _tiny_candidates(k=5, d=4)
    rng = np.random.RandomState(1)
    x = rng.rand(400, 4).astype(np.float32)
    y = rng.randint(0, 5, 400)
    on_card = dse.DesignSpace.from_candidates(cands, 5, hwcost.CostModel(),
                                              device=card)
    host = dse.DesignSpace.from_candidates(cands, 5, hwcost.CostModel(),
                                           device="cpu")
    scores = on_card.machine.pair_scores(x)
    clear = np.abs(scores) > 1e-5
    bits = on_card.machine.pair_bits(x)
    np.testing.assert_array_equal(bits[clear],
                                  host.machine.pair_bits(x)[clear])
    np.testing.assert_allclose(scores, host.machine.pair_scores(x),
                               atol=1e-5, rtol=1e-5)
    sw = on_card.sweep(x, y)
    np.testing.assert_array_equal(
        sw.accuracy, dse.assignment_accuracies(bits, sw.assignments, y, 5,
                                               device="cpu"))


@pytest.mark.cuda
def test_zero_offset_variant_bit_identical_on_card(card):
    from repro_torch.api import compiled

    cands = _tiny_candidates()
    x = np.random.RandomState(2).rand(64, 3).astype(np.float32)
    mc = compiled.compile_variants(cands, 3, key=0, n_variants=32,
                                   device=card)
    nominal = compiled.compile_candidates(cands, 3, device=card)
    np.testing.assert_array_equal(mc.pair_scores(x)[0],
                                  nominal.pair_scores(x))
    np.testing.assert_array_equal(mc.pair_bits(x)[0], nominal.pair_bits(x))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["iid", "sobol"])
def test_streamed_peak_memory_is_flat_on_card(card, method):
    """The peak card memory of a streamed run does not grow with V: a run
    of 40 chunks stays within one chunk's buffers of a run of one."""
    from repro_torch.api import compiled

    cands = _tiny_candidates(m=12)
    rng = np.random.RandomState(3)
    x = rng.rand(64, 3).astype(np.float32)
    y = rng.randint(0, 3, 64)
    a = np.ones((1, 3), bool)
    sm = compiled.compile_mc_stream(cands, 3, key=0, method=method,
                                    mc_chunk=512, device=card)
    peaks = {}
    for v in (512, 512, 512 * 40):          # the first run warms up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = sm.stream(x, y, a, n_variants=v, accuracy_floor=0.5)
        torch.cuda.synchronize()
        peaks[v] = torch.cuda.max_memory_allocated()
        assert out["count"] == float(v)
    chunk_bytes = 4 * 512 * (sm.mismatch_dim + 3 * 64 * 12)
    assert abs(peaks[512 * 40] - peaks[512]) <= chunk_bytes, peaks


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rbf", "hw"])
def test_size_sharded_grid_on_one_card(card, kind):
    """Three shards on one card, each on its own CUDA stream and each one
    K2 launch, give the global grid within 1e-6."""
    from repro_torch.core import trainer
    from repro_torch.kernels import ops

    rng = np.random.RandomState(0)
    x = rng.rand(300, 3)
    y = rng.randint(0, 5, 300)
    padded = trainer.pad_pairs(x, y, 5, n_folds=4, seed=0)
    cs = np.array([1.0, 10.0])
    if kind == "hw":
        hw = trainer.default_hw(0)
        kind, g = hw.kernel_response, trainer.hw_gamma_grid(hw, 2)
    else:
        g = np.array([0.5, 2.0])
    want = trainer.family_cv_grid(padded, kind, g, cs, 15, device=card)
    ops.reset_launches()
    got = trainer.family_cv_grid_size_sharded(padded, kind, g, cs, 15,
                                              devices=[card] * 3)
    assert ops.launch_counts()["solver"] == 3
    np.testing.assert_allclose(got, want, atol=1e-6)


def _dag_classifiers(k=6):
    """Linear, rbf and analog 'hw' pairs in turn, trained on the CPU."""
    from repro_torch.core import analog, ovo, svm, trainer

    rng = np.random.RandomState(0)
    x = rng.rand(300, 3)
    y = rng.randint(0, k, 300)
    hw = trainer.default_hw(0)
    g_hw = float(trainer.hw_gamma_grid(hw)[3])
    clfs = []
    for pi, (ci, cj) in enumerate(ovo.class_pairs(k)):
        mask = (y == ci) | (y == cj)
        yy = np.where(y[mask] == ci, 1.0, -1.0)
        kind = ("linear", "rbf", hw.kernel_response)[pi % 3]
        m = svm.train_binary(x[mask], yy, kind,
                             gamma=g_hw if pi % 3 == 2 else 2.0, c=1.0,
                             n_epochs=40, device="cpu")
        clfs.append(analog.AnalogBinaryClassifier.deploy(m, hw)
                    if pi % 3 == 2 else ovo.FloatBitClassifier(m))
    return clfs, rng.rand(500, 3)


@pytest.mark.cuda
def test_dag_labels_card_equal_cpu_off_ties(card):
    """The DAG front on the card (gathers and step plans on the device, no
    K1) gives the CPU machine's labels wherever every pair's score is off
    ties, and ``decide_dag`` of the card's own dense bits."""
    from repro_torch.api import compile_machine
    from repro_torch.core import ovo
    from repro_torch.kernels import ops

    clfs, x = _dag_classifiers()
    on_card = compile_machine(clfs, n_classes=6, decider="dag", device=card)
    host = compile_machine(clfs, n_classes=6, decider="dag", device="cpu")
    assert {b.kind for b in on_card._kernel_banks} == {"rbf", "hw"}
    ops.reset_launches()
    got = on_card.predict(x)
    assert ops.launch_counts()["kernel_matrix"] == 0
    clear = (np.abs(host.decision_scores(x)) > 1e-5).all(axis=1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], host.predict(x)[clear])
    np.testing.assert_array_equal(
        got[clear], ovo.decide_dag(on_card.predict_bits(x), 6)[clear])


# -- fleet serving ---------------------------------------------------------------


def _fleet_members(device, decider="votes"):
    """Three members on ``device`` built from the same trained classifiers:
    linear + rbf (K1) + analog pairs at K = 6, linear + rbf at K = 3 and at
    K = 4 (d = 3)."""
    from repro_torch.api import compile_machine

    clfs6, _ = _dag_classifiers(6)
    clfs4, _ = _dag_classifiers(4)
    clfs3, _ = _dag_classifiers(3)
    return {"six": compile_machine(clfs6, n_classes=6, decider=decider,
                                   device=device),
            "four": compile_machine(clfs4, n_classes=4, decider=decider,
                                    device=device),
            "three": compile_machine(clfs3, n_classes=3, decider=decider,
                                     device=device)}


@pytest.mark.cuda
@pytest.mark.parametrize("decider", ["votes", "dag"])
def test_fleet_bit_identical_to_members_on_card(card, decider):
    """Inside the port, fleet against member is a bit-identity contract on
    the card as on the CPU: the same banks through the same operations on
    the same rows."""
    from repro_torch.api import compile_fleet

    members = _fleet_members(card, decider)
    fleet = compile_fleet(members, decider=decider)
    assert fleet.device.type == "cuda"
    x = np.random.RandomState(5).rand(300, 3).astype(np.float32)
    for mid, m in members.items():
        np.testing.assert_array_equal(
            fleet.decision_scores(x, mid).view(np.int32),
            m.decision_scores(x).view(np.int32))
        np.testing.assert_array_equal(fleet.predict(x, mid), m.predict(x))


@pytest.mark.cuda
def test_engine_on_card_matches_member_labels_off_ties(card):
    """The engine on the card: pinned slots, its own stream, one event per
    batch; every label equals its member's off ties, and each dispatch of
    the votes fleet launches K1 once per rbf bank."""
    from repro_torch.api import compile_fleet
    from repro_torch.kernels import ops
    from repro_torch.serving import SVMEngine

    members = _fleet_members(card)
    fleet = compile_fleet(members)
    n_rbf = sum(b.kind == "rbf" for m in members.values()
                for b in m._kernel_banks)
    rng = np.random.RandomState(6)
    eng = SVMEngine(fleet, max_batch=64, max_wait_ms=1.0, pipeline_depth=2)
    slot = eng._staging[8][0]
    assert slot.x.is_pinned() and slot.out.is_pinned()
    assert slot.dev_bufs[0][0].is_cuda
    with eng:
        eng.warmup()
        ops.reset_launches()
        reqs = [(mid, rng.rand(int(k), 3).astype(np.float32))
                for mid, k in zip(rng.choice(list(members), 200),
                                  rng.randint(1, 9, 200))]
        futs = [eng.submit(x, mid) for mid, x in reqs]
        got = [f.result(timeout=60.0) for f in futs]
    s = eng.stats.summary()
    assert ops.launch_counts()["kernel_matrix"] == n_rbf * s["n_batches"]
    assert all(d["device_ms"] > 0 for d in s["dispatch"].values())
    for (mid, x), lab in zip(reqs, got):
        m = members[mid]
        clear = (np.abs(m.decision_scores(x)) > 1e-5).all(axis=1)
        np.testing.assert_array_equal(lab[clear], m.predict(x)[clear])


@pytest.mark.cuda
def test_engine_error_at_the_event_fails_its_futures(card):
    """A failure that surfaces when the batcher waits on a batch's event
    fails that batch's futures and stops the engine."""
    from repro_torch.api import compile_fleet
    from repro_torch.serving import SVMEngine

    fleet = compile_fleet(_fleet_members(card))
    eng = SVMEngine(fleet, max_batch=8, max_wait_ms=0.5)
    orig = eng._forward

    class Failing:
        start = None

        def __init__(self, launches):
            self.launches = launches

        def wait(self):
            for launch in self.launches:
                launch.wait()
            raise RuntimeError("CUDA error: device-side assert triggered")

    eng._forward = lambda slot: [Failing(orig(slot))]
    with eng:
        fut = eng.submit(np.zeros(3, np.float32), "six")
        with pytest.raises(RuntimeError, match="device-side assert"):
            fut.result(timeout=30.0)
        eng._thread.join(timeout=10.0)
        with pytest.raises(RuntimeError, match="failed batch"):
            eng.submit(np.zeros(3, np.float32), "six")


@pytest.mark.cuda
def test_mesh_legs_on_one_card_equal_the_unsharded_paths(card):
    """At d = 1 on the card every mesh leg is the unsharded program: the
    serving mesh's labels against the fleet's, the variants mesh's stream
    against the stream without a mesh, and the trainer mesh's CV grid (one
    K2 launch per share) against the local grid, bit for bit; two shares
    on the same card equal them too (the stream within the reference
    test's atol 1e-5, its histogram within 1e-3)."""
    from repro_torch.api import compile_fleet, compiled
    from repro_torch.core import trainer
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod

    fleet = compile_fleet(_fleet_members(card))
    x = np.random.RandomState(7).rand(64, 3).astype(np.float32)
    ids = ["six", "four", "three"] * 21 + ["six"]
    for n in (1, 2):
        fwd = fleet.shard(mesh_mod.make_serving_mesh(devices=[card] * n))
        np.testing.assert_array_equal(fwd.predict(x, ids),
                                      fleet.predict(x, ids))
    cands = _tiny_candidates()
    y = np.random.RandomState(8).randint(0, 3, 64)
    a = np.ones((1, 3), bool)
    sm = compiled.compile_mc_stream(cands, 3, key=0, mc_chunk=64,
                                    device=card)
    lo = sm.stream(x, y, a, n_variants=200, accuracy_floor=0.5)
    sh = sm.stream(x, y, a, n_variants=200, accuracy_floor=0.5,
                   mesh=mesh_mod.make_variant_mesh(1))
    for k in ("mean", "std", "worst", "best", "yield", "hist"):
        np.testing.assert_array_equal(sh[k], lo[k], err_msg=k)
    two = sm.stream(x, y, a, n_variants=200, accuracy_floor=0.5,
                    mesh=mesh_mod.make_variant_mesh(devices=[card] * 2))
    for k in ("mean", "std", "worst", "best", "yield"):
        np.testing.assert_allclose(two[k], lo[k], atol=1e-5, err_msg=k)
    np.testing.assert_allclose(two["hist"], lo["hist"], atol=1e-3)
    rng = np.random.RandomState(0)
    padded = trainer.pad_pairs(rng.rand(200, 3), rng.randint(0, 4, 200), 4)
    g, cs = np.array([0.5, 2.0]), np.array([1.0, 10.0])
    want = trainer.family_cv_grid(padded, "rbf", g, cs, 15, device=card)
    for n in (1, 2):
        ops.reset_launches()
        got = trainer.family_cv_grid(padded, "rbf", g, cs, 15,
                                     mesh=mesh_mod.make_trainer_mesh(
                                         devices=[card] * n))
        assert ops.launch_counts()["solver"] == n
        np.testing.assert_array_equal(got, want)

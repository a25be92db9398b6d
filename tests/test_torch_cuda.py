"""The port's hand CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU (a CUDA kernel has no CPU mode): they carry the
``cuda`` marker and skip without a card.  Run them on one with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the reference package, so it runs where
only the port is installed.  Tolerances are those of
tests/test_torch_kernels.py (K1: atol max(5e-6, 2e-6 gamma), rtol 1e-5;
K2) and tests/test_torch_lm_kernels.py (K3: 2e-5 in f32, 2e-2 in bf16; K4
and each of its passes: atol 1e-4).
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

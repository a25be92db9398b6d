"""The port's hand CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU (a CUDA kernel has no CPU mode): they carry the
``cuda`` marker and skip without a card.  Run them on one with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the reference package, so it runs where
only the port is installed.  Tolerances are those of
tests/test_torch_kernels.py (K1: atol max(5e-6, 2e-6 gamma), rtol 1e-5;
K2) and tests/test_torch_lm_kernels.py (K3: 2e-5 in f32, 2e-2 in bf16, at
every head dim the configs use, 32 to 128; K4 and each of its passes: atol
1e-4, at state widths up to 128).  K3-bwd against its plain twin at
every head dim 32 to 128 and mask kind: f32 max
|err| <= 1e-4 * max(1, max|plain|), bf16 relative L2 <= 2^-7 against the
twin run in f32 on the same bf16 inputs, lse within 1e-5 of the logits'
logsumexp; a train step on the card against the same step with the plain
versions: loss 1e-5 relative, gradients 1e-4 * max(1, max|g|) and
relative L2 1e-2 per leaf.  K4-bwd against its plain twin (and each of
its four passes) at ds 16 and 128 and padded state widths: each leaf within
relative L2 1e-4 and max |err| <= 1e-4 * max(1, max|plain|), bit for bit
twice, its planted fault caught; reduced hymba and mamba2 train steps on
the card against the plain versions, by the train step's rule.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import kernel_budget
from repro_torch.kernels import (
    flash_attention, flash_attention_bwd, ops, rbf, ref, solver, ssd, ssd_bwd,
)


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


def _k4b_inputs(seed, b, s, h, dh, g, ds, chunk, a_scale, dev):
    """K4-bwd's inputs: the scan's, K4's own cum, entering and final states,
    dy and dfinal."""
    rng = np.random.RandomState(seed)
    x, a, bm, cm = (_t(v).to(dev) for v in (
        rng.randn(b, s, h, dh) * 0.3, -np.abs(rng.randn(b, s, h)) * a_scale,
        rng.randn(b, s, g, ds) * 0.3, rng.randn(b, s, g, ds) * 0.3))
    dy, dfin = (_t(v).to(dev) for v in (rng.randn(b, s, h, dh),
                                        rng.randn(b, h, dh, ds)))
    _, s_fin, cum, s_prev = ssd.ssd_passes_cuda(x, a, bm, cm, chunk)
    return x, a, bm, cm, cum, s_prev, s_fin, dy, dfin


def _k4b_close(got, want, name):
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-4 * scale, name
    assert _rel_l2(got, want) <= 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("s,chunk,a_scale", [(256, 128, 0.3), (512, 64, 3.0),
                                             (128, 32, 0.3)])
@pytest.mark.parametrize("dh,g,ds", [(64, 1, 16), (64, 1, 128), (16, 2, 8),
                                     (64, 2, 5), (16, 1, 24)])
@pytest.mark.parametrize("dfinal", [True, False])
def test_k4b_kernel_matches_plain_twin(card, s, chunk, a_scale, dh, g, ds,
                                       dfinal):
    """K4-bwd against ``ref.ssd_scan_bwd`` on the same inputs, with and
    without a final state gradient; two launches bit for bit."""
    inp = list(_k4b_inputs(ds + s, 2, s, 4, dh, g, ds, chunk, a_scale, card))
    if not dfinal:
        inp[-1] = None
    got = ssd_bwd.ssd_scan_bwd_cuda(*inp, chunk)
    again = ssd_bwd.ssd_scan_bwd_cuda(*inp, chunk)
    want = ref.ssd_scan_bwd(*inp, chunk)
    torch.cuda.synchronize()
    for name, g_, g2, w in zip(("dx", "da", "dB", "dC"), got, again, want):
        _k4b_close(g_, w, name)
        assert torch.equal(g_, g2), name


@pytest.mark.cuda
@pytest.mark.parametrize("dh,g,ds", [(64, 1, 16), (64, 1, 128), (16, 2, 5)])
def test_k4b_passes_match_their_plain_twins(card, dh, g, ds):
    """Each of K4-bwd's four passes against its plain twin on the kernel's
    own inputs to it (pass 1 alone with ``chunk_states_only``)."""
    inp = _k4b_inputs(7, 2, 512, 4, dh, g, ds, 128, 0.3, card)
    x, a, bm, cm, cum, s_prev, s_fin, dy, dfin = inp
    one = ssd_bwd.ssd_bwd_passes_cuda(*inp, 128, chunk_states_only=True)
    full = ssd_bwd.ssd_bwd_passes_cuda(*inp, 128)
    u, dch, dcum = ref.ssd_bwd_chunk_states(dy, cm, cum, s_prev, 128)
    dsn = ref.ssd_bwd_state_pass(cum, one[4], dfin, 128)
    third = ref.ssd_bwd_chunk(x, bm, cm, dy, cum, s_prev, s_fin, full[4],
                              one[6], one[7], 128)
    fourth = ref.ssd_bwd_group_sum(full[5], full[6], g)
    torch.cuda.synchronize()
    for name, got, want in (("u", one[4], u), ("dch1", one[6], dch),
                            ("dcum1", one[7], dcum), ("dsn", full[4], dsn),
                            ("dx", full[0], third[0]),
                            ("da", full[1], third[1]),
                            ("dbh", full[5], third[2]),
                            ("dch", full[6], third[3]),
                            ("dB", full[2], fourth[0]),
                            ("dC", full[3], fourth[1])):
        _k4b_close(got, want, name)


@pytest.mark.cuda
@pytest.mark.parametrize("ds", [16, 128])
def test_k4b_planted_fault_is_caught(card, ds):
    """Every j block skipping its last t block fails the twin check."""
    inp = _k4b_inputs(9, 2, 256, 4, 64, 1, ds, 128, 0.3, card)
    bad = ssd_bwd.ssd_scan_bwd_cuda(*inp, 128,
                                    fault=ssd_bwd.FAULT_DROP_LAST_T_BLOCK)
    want = ref.ssd_scan_bwd(*inp, 128)
    assert max(_rel_l2(g, w) for g, w in zip(bad, want)) > 1e-2


@pytest.mark.cuda
def test_k4b_four_device_launches_per_call(card):
    """One call is ``ssd_bwd.DEVICE_LAUNCHES`` device kernels, all named
    ``ssd_bwd_*``, and one counted launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inp = _k4b_inputs(3, 1, 256, 4, 64, 1, 16, 128, 0.3, card)
    ssd_bwd.ssd_scan_bwd_cuda(*inp, 128)
    torch.cuda.synchronize()
    before = ssd_bwd.LAUNCHES.count
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ssd_bwd.ssd_scan_bwd_cuda(*inp, 128)
        torch.cuda.synchronize()
    names = sorted(e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    assert len(names) == ssd_bwd.DEVICE_LAUNCHES == 4, names
    assert all("ssd_bwd_" in n for n in names), names
    assert ssd_bwd.LAUNCHES.count == before + 1


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


# ---------------------------------------------------------------------------
# The analyzer's kernel-budget pass against the libraries themselves
# ---------------------------------------------------------------------------

#: Threads per CTA of each kernel family (the launches' blocks).
BUDGET_THREADS = {"kernel_matrix_kernel": 256, "solver_kernel": 1024,
                  "flash_kernel": 256, "flash_wgmma_kernel": 288,
                  "ssd_chunk_state_kernel": 256, "ssd_state_pass_kernel": 256,
                  "ssd_chunk_scan_kernel": 256, "bwd_dot_kernel": 256,
                  "ssd_bwd_chunk_state_kernel": 256,
                  "ssd_bwd_state_pass_kernel": 256,
                  "ssd_bwd_chunk_kernel": 256,
                  "ssd_bwd_group_sum_kernel": 256,
                  "bwd_prep_kernel": 256, "bwd_dkv_kernel": 256,
                  "bwd_dq_kernel": 256, "bwd_dkv_wgmma_kernel": 384,
                  "bwd_dq_wgmma_kernel": 288, "bwd_dkv_sum_kernel": 256}


@pytest.mark.cuda
@pytest.mark.parametrize("library,label,args", kernel_budget.MAIN_PATH_CALLS,
                         ids=[c[1] for c in kernel_budget.MAIN_PATH_CALLS])
def test_budget_mirror_equals_library_plan(card, library, label, args):
    sms, optin = kernel_budget.card_limits()
    assert kernel_budget.library_plan(library, args) == \
        kernel_budget.mirror_plan(library, args, sms, optin)


@pytest.mark.cuda
def test_budget_mirror_equals_library_plan_at_chunk_states_and_ragged(card):
    """K4 and K4-bwd stopping after pass 1 and at a padded state, K1 past
    the unrolled d, K2 at one lane and
    at a card-filling grid, K3 at a single ragged q block."""
    sms, optin = kernel_budget.card_limits()
    for library, args in (
            ("ssd", (2, 256, 8, 2, 16, 5, 64, 1)),
            ("ssd", (1, 128, 4, 1, 64, 100, 128, 0)),
            ("ssd_bwd", (2, 256, 8, 2, 16, 5, 64, 1)),
            ("ssd_bwd", (1, 128, 4, 1, 64, 100, 128, 0)),
            ("kernel_matrix", (1, 1, 1, 7, 2)),
            ("solver", (1, 1, 1, 17, 3, 0)),
            ("solver", (132, 3, 70, 33, 2, 2)),
            ("flash_attention", (0, 1, 2, 1, 5, 1500, 32))):
        assert kernel_budget.library_plan(library, args) == \
            kernel_budget.mirror_plan(library, args, sms, optin), args


@pytest.mark.cuda
@pytest.mark.parametrize("library", kernel_budget.LIBRARIES)
def test_budget_attributes_of_every_instance(card, library):
    """Every template instance: its attributes read, within the card's
    limits, and any REG-BUDGET / REG-SPILL / SMEM-BUDGET waived by the
    port's baseline; the mirror names only instances the library has."""
    from pathlib import Path

    from repro_torch.analysis.report import load_baseline

    waivers = load_baseline(str(Path(__file__).resolve().parent.parent
                                / "analysis_baseline_torch.json"))
    names = kernel_budget.instance_names(library)
    for lib, _, args in kernel_budget.MAIN_PATH_CALLS:
        if lib == library:
            for ln in kernel_budget.mirror_plan(lib, args):
                assert ln.kernel in names
    for name in names:
        threads = BUDGET_THREADS[name.split("<")[0]]
        ln = kernel_budget.Launch(name, (1, 1, 1), (threads, 1, 1), 0)
        att = kernel_budget.library_attributes(library, ln)
        assert 0 < att.regs <= 255 and att.max_threads >= threads
        assert att.ctas_per_sm >= 1 and att.regs_per_sm == 65536
        findings = kernel_budget.check_launch(library, f"{library}[{name}]",
                                              ln, att.smem_optin, att)
        assert [f for f in findings
                if not any(w.covers(f) for w in waivers)] == [], name


@pytest.mark.cuda
def test_budget_recording_sees_launches_and_restores(card):
    from repro_torch.kernels import build

    x = torch.rand(50, 4, device=card)
    sv = torch.rand(3, 20, 4, device=card)
    gamma = torch.ones(3, device=card)
    lib = build.library("kernel_matrix")
    before = rbf.LAUNCHES.count
    with kernel_budget.record_launches() as seen:
        rbf.kernel_matrix_cuda(x, sv, gamma)
    assert seen["kernel_matrix"] == {(3, 50, 20, 4, 1)}
    assert rbf.LAUNCHES.count == before + 1 and rbf.LAUNCHES.shapes is None
    assert build.library("kernel_matrix") is lib
    assert kernel_budget.library_plan("kernel_matrix", (3, 50, 20, 4, 1)) \
        == kernel_budget.mirror_plan("kernel_matrix", (3, 50, 20, 4, 1))


@pytest.mark.cuda
def test_analysis_gate_on_the_card(card):
    from pathlib import Path

    from repro_torch.analysis.__main__ import main

    root = Path(__file__).resolve().parent.parent
    assert main(["--root", str(root), "--device", "cuda", "--baseline",
                 str(root / "analysis_baseline_torch.json")]) == 0


# ---------------------------------------------------------------------------
# K3-bwd and the training path
# ---------------------------------------------------------------------------

#: Mask kinds: (b, hq, hkv, sq, skv, causal, window, q_offset); each runs
#: at every head dim.  "window" is MQA (one kv head).
K3B_CASES = {
    "causal_gqa": (2, 4, 2, 300, 300, True, None, 0),
    "window": (1, 5, 1, 400, 400, True, 96, 0),
    "noncausal_ragged": (1, 4, 4, 150, 150, False, None, 0),
    "cross": (2, 4, 2, 40, 230, False, None, 0),
    "q_offset": (1, 4, 2, 70, 333, True, 100, 263),
}


def _k3b_inputs(case, dtype, dev, dh, seed=0):
    b, hq, hkv, sq, skv = K3B_CASES[case][:5]
    q, k, v = _qkv(seed, b, hq, hkv, sq, skv, dh, dtype, dev)
    do = torch.as_tensor(np.random.RandomState(seed + 1).randn(b, hq, sq, dh),
                         dtype=torch.float32).to(device=dev, dtype=dtype)
    return q, k, v, do


def _rel_l2(got, want):
    return float(torch.linalg.norm((got.float() - want.float()).reshape(-1))
                 / torch.linalg.norm(want.float().reshape(-1)))


def _logsumexp(q, k, causal, window, q_offset):
    """``torch.logsumexp`` of the masked f32 logits, per (b, q head)."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, sq, dh) / float(dh) ** 0.5
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    mask = ref._attn_mask(sq, 0, skv, causal, window, q_offset, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    return torch.logsumexp(logits, dim=-1).reshape(b, hq, sq)


def _k3b_ok(dtype, got, want):
    """The stated tolerance: f32 max |err| <= 1e-4 max(1, max |plain|),
    bf16 relative L2 <= 2^-7."""
    if dtype == torch.float32:
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        return float((got - want).abs().max()) <= tol
    return _rel_l2(got, want) <= 2 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("dh", flash_attention_bwd.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(K3B_CASES))
def test_k3_bwd_kernel_matches_its_plain_twin(card, case, dtype, dh):
    """Each dtype's kernels (bf16: tensor cores, f32: CUDA cores) against
    the plain twin run in f32 on the same inputs, twice bit for bit; the
    forward's lse (its lse-storing instance in bf16) against
    ``torch.logsumexp``."""
    causal, window, q_offset = K3B_CASES[case][5:]
    q, k, v, do = _k3b_inputs(case, dtype, card, dh)
    o, lse = flash_attention.flash_attention_cuda(q, k, v, causal, window,
                                                  q_offset, return_lse=True)
    before = flash_attention_bwd.LAUNCHES.count
    variant = (flash_attention_bwd.LAUNCHES_TC if dtype == torch.bfloat16
               else flash_attention_bwd.LAUNCHES_F32)
    before_variant = variant.count
    got = flash_attention_bwd.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, causal, window, q_offset)
    again = flash_attention_bwd.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, causal, window, q_offset)
    f32 = [t.float() for t in (q, k, v, o)]
    want = ref.flash_attention_bwd(*f32, lse, do.float(), causal, window,
                                   q_offset)
    torch.cuda.synchronize()
    assert flash_attention_bwd.LAUNCHES.count == before + 2
    assert variant.count == before_variant + 2
    for g, g2, w in zip(got, again, want):
        assert g.dtype == dtype and torch.equal(g, g2)
        assert _k3b_ok(dtype, g, w)
    lse_want = _logsumexp(q, k, causal, window, q_offset)
    seen = torch.isfinite(lse_want)
    assert torch.equal(torch.isfinite(lse), seen)
    assert float((lse - lse_want)[seen].abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dh", flash_attention_bwd.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_bwd_planted_fault_fails_the_check(card, dtype, dh):
    """Negative control: every q block dropping its last visible kv block
    fails, in each gradient, the check the kernel passes."""
    q, k, v, do = _k3b_inputs("causal_gqa", dtype, card, dh)
    o, lse = flash_attention.flash_attention_cuda(q, k, v, return_lse=True)
    bad = flash_attention_bwd.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, fault=flash_attention_bwd.FAULT_DROP_LAST_KV_BLOCK)
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(), o.float(),
                                   lse, do.float())
    torch.cuda.synchronize()
    for g, w in zip(bad, want):
        assert not _k3b_ok(dtype, g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", flash_attention_bwd.HEAD_DIMS)
def test_k3_bwd_function_runs_the_tensor_core_kernel_in_bf16(card, dh):
    """``ops.flash_attention`` on bf16 card tensors that need a gradient:
    one lse-storing forward and one tensor-core K3-bwd call, its gradients
    those of the kernel called directly."""
    q, k, v, do = _k3b_inputs("causal_gqa", torch.bfloat16, card, dh, seed=7)
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
    ops.reset_launches()
    ops.flash_attention(tq, tk, tv).backward(do)
    counts = ops.launch_counts()
    assert counts["flash_attention_bf16_wgmma"] == 1
    assert counts["flash_attention_bwd"] == 1
    assert counts["flash_attention_bwd_bf16_wgmma"] == 1
    assert counts["flash_attention_bwd_f32_cuda_cores"] == 0
    o, lse = flash_attention.flash_attention_cuda(q, k, v, return_lse=True)
    want = flash_attention_bwd.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_k3_bwd_refuses_other_head_dims(card):
    q, k, v, do = _qkv(1, 1, 2, 1, 64, 64, 80, torch.bfloat16, card) + [None]
    lse = torch.zeros(1, 2, 64, device=card)
    with pytest.raises(ValueError, match="80"):
        flash_attention_bwd.flash_attention_bwd_cuda(q, k, v, q, lse, q)
    q16 = q.to(torch.float16)
    with pytest.raises(TypeError, match="float16"):
        flash_attention_bwd.flash_attention_bwd_cuda(q16, q16, q16, q16, lse,
                                                     q16)


def _plain_kernels(monkeypatch):
    """Route the card's K3 and K3-bwd calls to their plain versions."""
    monkeypatch.setattr(flash_attention, "flash_attention_cuda",
                        ref.flash_attention)
    monkeypatch.setattr(flash_attention_bwd, "flash_attention_bwd_cuda",
                        ref.flash_attention_bwd)


def _train_grads(cfg, state, batch):
    from repro_torch.models import transformer as tfm

    for t in state["params"].parameters():
        t.grad = None
    loss, _ = tfm.forward_train(cfg, state["params"], batch)
    loss.backward()
    return float(loss), [t.grad.clone() for t in state["params"].parameters()]


@pytest.mark.cuda
def test_train_step_on_card_matches_plain_versions(card, monkeypatch):
    """Reduced granite-moe in f32 (B = 2, S = 200, remat "full"): the
    card's loss and gradients through K3 / K3-bwd against the same model
    with the plain versions on the card; every leaf's gradient finite and
    nonzero; K3-bwd with dq zeroed fails the check."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import step as step_mod

    cfg = dataclasses.replace(configs.get("granite-moe-1b-a400m").reduced(),
                              remat="full")
    state = step_mod.init_train_state(cfg, opt_mod.AdamWConfig(), 0, card)
    rng = np.random.RandomState(0)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (2, 201)),
                           device=card)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ops.reset_launches()
    loss, grads = _train_grads(cfg, state, batch)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 * cfg.n_layers
    assert counts["flash_attention_bwd"] == cfg.n_layers
    for g in grads:
        assert torch.isfinite(g).all() and g.abs().max() > 0

    with monkeypatch.context() as m:
        _plain_kernels(m)
        loss_p, grads_p = _train_grads(cfg, state, batch)
    assert abs(loss - loss_p) <= 1e-5 * abs(loss_p)
    for g, w in zip(grads, grads_p):
        assert float((g - w).abs().max()) <= 1e-4 * max(
            1.0, float(w.abs().max()))
        assert _rel_l2(g, w) <= 1e-2

    real = flash_attention_bwd.flash_attention_bwd_cuda

    def dq_zeroed(*args, **kw):
        dq, dk, dv = real(*args, **kw)
        return torch.zeros_like(dq), dk, dv

    with monkeypatch.context() as m:
        m.setattr(flash_attention_bwd, "flash_attention_bwd_cuda", dq_zeroed)
        _, grads_bad = _train_grads(cfg, state, batch)
    # Most leaves' gradients are far below 1, so the dropped dq shows in
    # the relative L2 (1.0 on the query projection's leaf).
    assert max(_rel_l2(g, w) for g, w in zip(grads_bad, grads_p)) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-2.7b"])
def test_ssm_training_on_card_matches_plain_versions(card, monkeypatch, arch):
    """Reduced hymba and mamba2 in f32 (B = 2, S = 200, padded to 256 for
    the scan; remat "full"): loss and gradients through K3 / K3-bwd and K4
    / K4-bwd against the same model with the plain versions on the card;
    every leaf finite and nonzero; K4 twice and K4-bwd once per layer;
    K4-bwd's planted fault fails the check."""
    import dataclasses
    import functools

    from repro_torch import configs
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import step as step_mod

    cfg = dataclasses.replace(configs.get(arch).reduced(), remat="full")
    state = step_mod.init_train_state(cfg, opt_mod.AdamWConfig(), 0, card)
    rng = np.random.RandomState(1)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (2, 201)),
                           device=card)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ops.reset_launches()
    loss, grads = _train_grads(cfg, state, batch)
    counts = ops.launch_counts()
    assert counts["ssd"] == 2 * cfg.n_layers
    assert counts["ssd_bwd"] == counts["ssd_scan_backward"] == cfg.n_layers
    for g in grads:
        assert torch.isfinite(g).all() and g.abs().max() > 0

    with monkeypatch.context() as m:
        _plain_kernels(m)
        m.setattr(ssd, "ssd_passes_cuda", ref.ssd_passes)
        m.setattr(ssd_bwd, "ssd_scan_bwd_cuda", ref.ssd_scan_bwd)
        loss_p, grads_p = _train_grads(cfg, state, batch)
    assert abs(loss - loss_p) <= 1e-5 * abs(loss_p)
    for g, w in zip(grads, grads_p):
        assert float((g - w).abs().max()) <= 1e-4 * max(
            1.0, float(w.abs().max()))
        assert _rel_l2(g, w) <= 1e-2

    with monkeypatch.context() as m:
        m.setattr(ssd_bwd, "ssd_scan_bwd_cuda", functools.partial(
            ssd_bwd.ssd_scan_bwd_cuda,
            fault=ssd_bwd.FAULT_DROP_LAST_T_BLOCK))
        _, grads_bad = _train_grads(cfg, state, batch)
    assert max(_rel_l2(g, w) for g, w in zip(grads_bad, grads_p)) > 1e-2

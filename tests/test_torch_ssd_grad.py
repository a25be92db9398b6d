"""K4's gradient on the CPU: the plain twin of K4-bwd
(``ref.ssd_scan_bwd``), the plain twins of its five passes (and their
products in split TF32, as the kernel's tensor cores compute them) and
``ops.SSDScan``, against torch autograd through the plain scan and against
the jitted ``jax.vjp`` of the reference's ``repro.models.ssm.ssd_chunked``.

Inputs are drawn with numpy from a seed as the reference sweep draws them
(``tests/test_kernels_pallas.py``: x, B, C ~ 0.3 N(0, 1), a = -0.3 |N(0,
1)|, here also -3 |N(0, 1)|, a decay that underflows within a chunk), with
random dy and dfinal; b = 2, nh = 4, g 1 / 2, dh 16 / 64, ds 8 / 16 / 128, s
128 / 256 / 200 (200 through ``ssd_chunked``'s zero padding).  Tolerance:
the reference sweep's SSD atol, max |err| <= 1e-4 max(1, max |g|), beside
relative L2 <= 1e-4 per leaf (dcum is a difference of row and column sums,
so da is also held as a whole).  The card's kernel is held to the same twin
in ``tests/test_torch_cuda.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import ssm as r_ssm
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm

TOL = 1e-4

#: (s, dh, g, ds, chunk, a_scale); b = 2, nh = 4.
CASES = {
    "dh16_g2_ds8": (256, 16, 2, 8, 128, 0.3),
    "dh64_g1_ds16": (128, 64, 1, 16, 64, 0.3),
    "dh16_g1_ds128_padded": (200, 16, 1, 128, 64, 0.3),
    "dh64_g2_ds16_strong": (256, 64, 2, 16, 32, 3.0),
}
B, NH = 2, 4


@functools.lru_cache(maxsize=None)
def _inputs(case):
    """x, a, B, C, dy, dfinal as numpy arrays (seeded per case)."""
    s, dh, g, ds, _, a_scale = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    x = rng.randn(B, s, NH, dh) * 0.3
    a = -np.abs(rng.randn(B, s, NH)) * a_scale
    bm = rng.randn(B, s, g, ds) * 0.3
    cm = rng.randn(B, s, g, ds) * 0.3
    dy = rng.randn(B, s, NH, dh)
    dfin = rng.randn(B, NH, dh, ds)
    return tuple(v.astype(np.float32) for v in (x, a, bm, cm, dy, dfin))


def _t(v, grad=False):
    return torch.from_numpy(v).clone().requires_grad_(grad)


def _padded(case):
    """The inputs padded with zeros to a multiple of the chunk, as
    ``ssd_chunked`` pads them (dy's padded rows 0), as tensors."""
    s, chunk = CASES[case][0], CASES[case][4]
    pad = (-s) % chunk
    x, a, bm, cm, dy, dfin = (_t(v) for v in _inputs(case))
    x, bm, cm, dy = (F.pad(v, (0, 0, 0, 0, 0, pad)) for v in (x, bm, cm, dy))
    return x, F.pad(a, (0, 0, 0, pad)), bm, cm, dy, dfin


def _twin(case, dfinal=True):
    """``ref.ssd_scan_bwd`` on the padded inputs, from the forward's twins
    -> (dx, da, dB, dC) at the unpadded length."""
    s, chunk = CASES[case][0], CASES[case][4]
    x, a, bm, cm, dy, dfin = _padded(case)
    _, s_fin, cum, s_prev = ref.ssd_passes(x, a, bm, cm, chunk)
    grads = ref.ssd_scan_bwd(x, a, bm, cm, cum, s_prev, s_fin, dy,
                             dfin if dfinal else None, chunk)
    return [g[:, :s] for g in grads]


@functools.lru_cache(maxsize=None)
def _reference_vjp(case):
    """The jitted ``jax.vjp`` of the reference's ``ssd_chunked`` with (dy,
    dfinal) -> numpy (dx, da, dB, dC)."""
    chunk = CASES[case][4]
    x, a, bm, cm, dy, dfin = _inputs(case)

    def f(x, a, bm, cm):
        return r_ssm.ssd_chunked(x, a, bm, cm, chunk=chunk)

    @jax.jit
    def grads(x, a, bm, cm, dy, dfin):
        _, vjp = jax.vjp(f, x, a, bm, cm)
        return vjp((dy, dfin))

    out = grads(*(jnp.asarray(v) for v in (x, a, bm, cm, dy, dfin)))
    return [np.asarray(g) for g in out]


def _close(got, want, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else want
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0,
                               err_msg=name)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= TOL, (name, rel)


def _autograd_of_plain(case, dfinal=True):
    """torch autograd through ``ref.ssd_scan`` on the padded inputs ->
    (dx, da, dB, dC) at the unpadded length."""
    s, chunk = CASES[case][0], CASES[case][4]
    x, a, bm, cm, dy, dfin = _padded(case)
    leaves = [v.requires_grad_(True) for v in (x, a, bm, cm)]
    y, s_fin = ref.ssd_scan(*leaves, chunk)
    loss = (y * dy).sum() + ((s_fin * dfin).sum() if dfinal else 0.0)
    loss.backward()
    return [v.grad[:, :s] for v in leaves]


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_torch_autograd_of_the_plain_scan(case):
    for name, got, want in zip(("dx", "da", "dB", "dC"), _twin(case),
                               _autograd_of_plain(case)):
        _close(got, want, name)


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_the_reference_jitted_vjp(case):
    """The acceptance check: ``ref.ssd_scan_bwd`` against the jitted
    ``jax.vjp`` of the reference's ``ssd_chunked``."""
    for name, got, want in zip(("dx", "da", "dB", "dC"), _twin(case),
                               _reference_vjp(case)):
        _close(got, want, name)


def _pass_chain(x, a, bm, cm, dy, dfin, chunk, s_fin, cum, s_prev):
    """The five pass twins chained: chunk states, state pass, chunk (the
    intra-chunk terms), state terms (with da), slice sum -> (dx, da, dB,
    dC)."""
    u, dcp, dcum = ref.ssd_bwd_chunk_states(dy, cm, cum, s_prev, chunk)
    dsn = ref.ssd_bwd_state_pass(cum, u, dfin, chunk)
    dx, dcum, dbp, dcp = ref.ssd_bwd_chunk(x, bm, cm, dy, cum, dcum, dcp,
                                           chunk)
    dx, da, dbp = ref.ssd_bwd_state_terms(x, bm, cum, s_prev, s_fin, dsn, dx,
                                          dcum, dbp, chunk)
    db, dc = ref.ssd_bwd_slice_sum(dbp, dcp)
    return dx, da, db, dc


@pytest.mark.parametrize("case", list(CASES))
def test_pass_twins_compose_to_the_whole(case):
    """Pass 1 (each chunk's U, the entering states' dC per slice of heads
    and its dcum terms), pass 2 (the reverse state pass), pass 3 (the
    intra-chunk terms), pass 4 (the leaving states' terms and da) and pass
    5 (the slice sum), chained, give ``ref.ssd_scan_bwd`` and the
    reference's jitted VJP."""
    s, _, g, _, chunk, _ = CASES[case]
    x, a, bm, cm, dy, dfin = _padded(case)
    _, s_fin, cum, s_prev = ref.ssd_passes(x, a, bm, cm, chunk)
    got = _pass_chain(x, a, bm, cm, dy, dfin, chunk, s_fin, cum, s_prev)
    for name, g_, want, vjp in zip(("dx", "da", "dB", "dC"), got,
                                   _twin(case), _reference_vjp(case)):
        _close(g_[:, :s], want, name)
        _close(g_[:, :s], vjp, name)


def _tf32(v: torch.Tensor, nearest: bool) -> torch.Tensor:
    """f32 ``v`` with its low 13 mantissa bits cleared: rounded to the
    nearest TF32 value (ties away from zero, as ``cvt.rna.tf32.f32``), or
    cut as the tensor core cuts an operand it reads as TF32."""
    bits = v.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _split_einsum(eq, a, b):
    """A two-operand einsum as K4-bwd's tensor cores compute it in split
    TF32: a = a_hi + a_lo, a_hi the nearest TF32 value and a_lo = a - a_hi
    read as TF32, then a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms
    first, each product in f32."""
    einsum = _split_einsum.einsum
    ah, bh = _tf32(a, True), _tf32(b, True)
    al, bl = _tf32(a - ah, False), _tf32(b - bh, False)
    return (einsum(eq, al, bh) + einsum(eq, ah, bl)) + einsum(eq, ah, bh)


_split_einsum.einsum = torch.einsum


@pytest.mark.parametrize("ds", [16, 128])
@pytest.mark.parametrize("a_scale", [0.3, 3.0])
def test_split_tf32_products_hold_the_tolerance(monkeypatch, ds, a_scale):
    """The precision plan of K4-bwd's tensor-core products, before any card
    run: the pass twins with every product (each two-operand einsum) in
    split TF32, against the same twins in f64, at mild and strong decay
    (a x 0.3, x 3.0): dx, da, dB and dC within ``TOL`` (max |err| <= TOL
    max(1, max |g|) and relative L2 <= TOL).  One-pass TF32 would not
    hold it: its products keep about three decimal digits."""
    b, s, nh, g, dh, chunk = 2, 256, 4, 1, 64, 128
    rng = np.random.RandomState(ds + int(10 * a_scale))
    draw = [rng.randn(b, s, nh, dh) * 0.3, -np.abs(rng.randn(b, s, nh))
            * a_scale, rng.randn(b, s, g, ds) * 0.3,
            rng.randn(b, s, g, ds) * 0.3, rng.randn(b, s, nh, dh),
            rng.randn(b, nh, dh, ds)]
    x, a, bm, cm, dy, dfin = (torch.from_numpy(v.astype(np.float32))
                              for v in draw)
    _, s_fin, cum, s_prev = ref.ssd_passes(x, a, bm, cm, chunk)
    f32 = (x, a, bm, cm, dy, dfin, chunk, s_fin, cum, s_prev)
    want = _pass_chain(*(v.double() if isinstance(v, torch.Tensor) else v
                         for v in f32))
    with monkeypatch.context() as m:
        m.setattr(torch, "einsum", _split_einsum)
        got = _pass_chain(*f32)
    for name, g_, w in zip(("dx", "da", "dB", "dC"), got, want):
        assert g_.dtype == torch.float32
        _close(g_, w.float(), name)


@pytest.mark.parametrize("case", list(CASES))
def test_ssdscan_on_the_cpu_equals_autograd_of_the_plain_scan(case):
    """``ops.ssd_scan`` with inputs that need a gradient goes through
    ``SSDScan`` (one backward pass counted); its outputs equal the no-grad
    scan's bit for bit and its gradients autograd's through
    ``ref.ssd_scan``."""
    s, chunk = CASES[case][0], CASES[case][4]
    x, a, bm, cm, dy, dfin = _padded(case)
    leaves = [v.requires_grad_(True) for v in (x, a, bm, cm)]
    ops.reset_launches()
    y, s_fin = ops.ssd_scan(*leaves, chunk=chunk)
    with torch.no_grad():
        y0, s0 = ops.ssd_scan(x, a, bm, cm, chunk=chunk)
    assert torch.equal(y, y0) and torch.equal(s_fin, s0)
    ((y * dy).sum() + (s_fin * dfin).sum()).backward()
    counts = ops.launch_counts()
    assert counts["ssd_scan_backward"] == 1
    assert counts["ssd"] == counts["ssd_bwd"] == 0   # plain versions
    for name, v, want in zip(("dx", "da", "dB", "dC"), leaves,
                             _autograd_of_plain(case)):
        _close(v.grad[:, :s], want, name)


@pytest.mark.parametrize("case", list(CASES))
def test_ssd_chunked_gradient_matches_the_reference(case):
    """The model's ``ssd_chunked`` (zero padding, ``y[:, :s]``, the scan
    through ``SSDScan``) differentiated by torch against the reference's
    jitted vjp, dfinal included."""
    chunk = CASES[case][4]
    x, a, bm, cm, dy, dfin = _inputs(case)
    leaves = [_t(v, grad=True) for v in (x, a, bm, cm)]
    y, s_fin = ssm.ssd_chunked(*leaves, chunk=chunk)
    ((y * _t(dy)).sum() + (s_fin * _t(dfin)).sum()).backward()
    for name, v, want in zip(("dx", "da", "dB", "dC"), leaves,
                             _reference_vjp(case)):
        _close(v.grad, want, name)


def test_a_final_state_without_gradient_is_zero():
    """Only y used: the final state's gradient reaches the backward as
    ``None`` and counts as zero (bit for bit the pass twins with dfinal
    None, which the backward runs off the card; the closed-form twin with
    dfinal None, and autograd without the final state's term)."""
    case = "dh16_g1_ds128_padded"
    s, chunk = CASES[case][0], CASES[case][4]
    x, a, bm, cm, dy, _ = _padded(case)
    _, s_fin, cum, s_prev = ref.ssd_passes(x, a, bm, cm, chunk)
    chain = _pass_chain(x, a, bm, cm, dy, None, chunk, s_fin, cum, s_prev)
    leaves = [v.requires_grad_(True) for v in (x, a, bm, cm)]
    y, _ = ops.ssd_scan(*leaves, chunk=chunk)
    (y * dy).sum().backward()
    twin = _twin(case, dfinal=False)
    for name, v, got, want, plain in zip(
            ("dx", "da", "dB", "dC"), leaves, chain, twin,
            _autograd_of_plain(case, dfinal=False)):
        assert torch.equal(v.grad, got), name
        _close(v.grad[:, :s], want, name)
        _close(want, plain, name)


def test_padded_rows_get_zero_gradients():
    """Rows that ``ssd_chunked`` pads with zeros (x, B, C and a = 0, dy =
    0) get zero gradients in every input when the final state gets none."""
    case = "dh16_g1_ds128_padded"
    s, chunk = CASES[case][0], CASES[case][4]
    x, a, bm, cm, dy, _ = _padded(case)
    leaves = [v.requires_grad_(True) for v in (x, a, bm, cm)]
    y, _ = ops.ssd_scan(*leaves, chunk=chunk)
    (y * dy).sum().backward()
    for v in leaves:
        assert v.grad[:, s:].abs().max() == 0
        assert v.grad[:, :s].abs().max() > 0

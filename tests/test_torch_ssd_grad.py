"""K4's gradient on the CPU: the plain twin of K4-bwd
(``ref.ssd_scan_bwd``), the plain twins of its four passes and
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


@pytest.mark.parametrize("case", list(CASES))
def test_pass_twins_compose_to_the_whole(case):
    """Pass 1 (each chunk's U, the entering states' dC and dcum terms),
    pass 2 (the reverse state pass), pass 3 (the chunk terms) and pass 4
    (the group sum), chained, give ``ref.ssd_scan_bwd``."""
    s, _, g, _, chunk, _ = CASES[case]
    x, a, bm, cm, dy, dfin = _padded(case)
    _, s_fin, cum, s_prev = ref.ssd_passes(x, a, bm, cm, chunk)
    u, dch, dcum = ref.ssd_bwd_chunk_states(dy, cm, cum, s_prev, chunk)
    dsn = ref.ssd_bwd_state_pass(cum, u, dfin, chunk)
    dx, da, dbh, dch = ref.ssd_bwd_chunk(x, bm, cm, dy, cum, s_prev, s_fin,
                                         dsn, dch, dcum, chunk)
    db, dc = ref.ssd_bwd_group_sum(dbh, dch, g)
    for name, got, want in zip(("dx", "da", "dB", "dC"), (dx, da, db, dc),
                               _twin(case)):
        _close(got[:, :s], want, name)


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
    ``None`` and counts as zero (the twin with dfinal None, and autograd
    without the final state's term)."""
    case = "dh16_g1_ds128_padded"
    s, chunk = CASES[case][0], CASES[case][4]
    x, a, bm, cm, dy, _ = _padded(case)
    leaves = [v.requires_grad_(True) for v in (x, a, bm, cm)]
    y, _ = ops.ssd_scan(*leaves, chunk=chunk)
    (y * dy).sum().backward()
    twin = _twin(case, dfinal=False)
    for name, v, want, plain in zip(("dx", "da", "dB", "dC"), leaves, twin,
                                    _autograd_of_plain(case, dfinal=False)):
        assert torch.equal(v.grad[:, :s], want), name
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

"""The port's two SVM kernels against the JAX reference.

K1 (kernel matrix of a bank) and K2 (fused dual-ascent solver over lanes,
tile and Gram-input modes): on the CPU their plain PyTorch versions run,
and they are held to the reference's Pallas kernels in interpret mode, to
the reference's plain oracles and to the reference's blocked solver, at
the reference tests' tolerances (tests/test_kernels_pallas.py,
tests/test_solver_pallas.py).  The hand CUDA kernels themselves are held to
the plain versions by tests/test_torch_cuda.py, on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels as rkern
from repro.core import trainer as rtrainer
from repro.kernels import ref as rref
from repro.kernels.rbf import kernel_matrix_pallas
from repro.kernels.solver import dual_ascent_lanes_pallas
from repro_torch.core import trainer as ttrainer
from repro_torch.kernels import ops, rbf, ref, solver


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


# -- K1: kernel matrix ---------------------------------------------------------


@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (97, 130, 2)])
@pytest.mark.parametrize("kind", ["rbf", "sech2"])
@pytest.mark.parametrize("gamma", [0.1, 1.0, 30.0])
def test_kernel_matrix_plain_matches_pallas(n, m, d, kind, gamma):
    """A bank of two pairs (gamma and 2*gamma) against the Pallas kernel in
    interpret mode and the reference oracle, pair by pair."""
    rng = np.random.RandomState(11 * n + m + d)
    x = rng.rand(n, d).astype(np.float32)
    sv = rng.rand(2, m, d).astype(np.float32)
    gammas = np.asarray([gamma, 2.0 * gamma], np.float32)
    got = ops.rbf_matrix(_t(x), _t(sv), _t(gammas), kind=kind).numpy()
    assert got.shape == (2, n, m)
    oracle = rref.rbf_matrix if kind == "rbf" else rref.sech2_matrix
    for p in range(2):
        atol = max(5e-6, 2e-6 * float(gammas[p]))
        pallas = kernel_matrix_pallas(jnp.asarray(x), jnp.asarray(sv[p]),
                                      gammas[p], kind=kind, interpret=True)
        np.testing.assert_allclose(got[p], np.asarray(pallas), atol=atol,
                                   rtol=1e-5)
        np.testing.assert_allclose(
            got[p], np.asarray(oracle(jnp.asarray(x), jnp.asarray(sv[p]),
                                      gammas[p])), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("n_slope,v_t,v_scale", [
    (1.38, 0.02585, 0.5),     # the entry point's defaults, explicitly
    (1.7, 0.031, 0.8),        # non-default hardware constants
    (1.1, 0.02585, 1.0),      # the compiled machines' v_scale
])
def test_kernel_matrix_sech2_hardware_constants(n_slope, v_t, v_scale):
    rng = np.random.RandomState(5)
    x = rng.rand(40, 3).astype(np.float32)
    sv = rng.rand(1, 25, 3).astype(np.float32)
    kw = dict(n_slope=n_slope, v_t=v_t, v_scale=v_scale)
    got = ops.rbf_matrix(_t(x), _t(sv), _t([4.0]), kind="sech2", **kw)
    want = kernel_matrix_pallas(jnp.asarray(x), jnp.asarray(sv[0]), 4.0,
                                kind="sech2", bm=32, bn=32, interpret=True,
                                **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=5e-6,
                               rtol=1e-5)


def test_kernel_matrix_default_v_scale_is_half():
    """The entry point keeps the reference's historical v_scale=0.5."""
    rng = np.random.RandomState(2)
    x, sv = rng.rand(9, 2), rng.rand(1, 7, 2)
    got = ops.rbf_matrix(_t(x), _t(sv), _t([3.0]), kind="sech2")
    want = rref.sech2_matrix(jnp.asarray(x, jnp.float32),
                             jnp.asarray(sv[0], jnp.float32), 3.0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=5e-6,
                               rtol=1e-5)


# -- K2: solver lanes ------------------------------------------------------------


def _lanes(seed, p, n, d, g, l, c_hi=5.0):
    rng = np.random.RandomState(seed)
    x = rng.rand(p, n, d).astype(np.float32)
    y = np.where(rng.rand(p, n) > 0.5, 1.0, -1.0).astype(np.float32)
    c_box = (rng.rand(p, l, n) * c_hi * (rng.rand(p, l, n) > 0.2)
             ).astype(np.float32)
    gamma = (rng.rand(p, g) * 6.0 + 0.3).astype(np.float32)
    return x, y, c_box, gamma


@pytest.mark.parametrize("kind,n,d,g,l", [
    ("linear", 50, 3, 1, 4),
    ("rbf", 33, 4, 3, 5),      # n not a multiple of the block
    ("rbf", 7, 1, 2, 2),       # d = 1, n < block
    ("sech2", 40, 2, 2, 3),
])
def test_solve_lanes_plain_matches_pallas(kind, n, d, g, l):
    """Multi-lane grids vs the Pallas solver (interpret) and the
    reference's lanes oracle."""
    x, y, c_box, gamma = _lanes(n + d, 2, n, d, g, l)
    a, f = ops.solve_lanes(_t(x), _t(y), _t(c_box), _t(gamma), kind=kind,
                           n_epochs=25)
    a_pl, f_pl = dual_ascent_lanes_pallas(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(c_box),
        jnp.asarray(gamma), kind=kind, n_epochs=25, interpret=True)
    a_rf, f_rf = rref.solve_lanes(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(c_box), jnp.asarray(gamma),
                                  kind=kind, n_epochs=25)
    for a_want, f_want in ((a_pl, f_pl), (a_rf, f_rf)):
        np.testing.assert_allclose(a.numpy(), np.asarray(a_want),
                                   atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(f.numpy(), np.asarray(f_want), atol=5e-3,
                                   rtol=1e-3)


@pytest.mark.parametrize("seed,n,d,c,n_epochs", [
    (0, 37, 3, 2.0, 30), (1, 70, 1, 10.0, 40), (3, 101, 2, 100.0, 20)])
def test_solve_lanes_plain_matches_blocked_oracle(seed, n, d, c, n_epochs):
    """One rbf lane vs dual_coordinate_ascent_blocked, the oracle of
    record, on the Gram the engine trains on."""
    x, y, c_box, gamma = _lanes(seed, 1, n, d, 1, 1, c_hi=c)
    a, f = ops.solve_lanes(_t(x), _t(y), _t(c_box), _t(gamma), kind="rbf",
                           n_epochs=n_epochs)
    kp = rkern.kernel_matrix("rbf", jnp.asarray(x[0]), jnp.asarray(x[0]),
                             gamma[0, 0]) + 1.0
    a_or = np.asarray(rtrainer.dual_coordinate_ascent_blocked(
        kp, jnp.asarray(y[0]), jnp.asarray(c_box[0, 0]), n_epochs))
    scale = max(c, 1.0)
    np.testing.assert_allclose(a[0, 0, 0].numpy(), a_or, atol=5e-4 * scale,
                               rtol=1e-3)
    f_or = np.asarray(kp @ (jnp.asarray(a_or) * y[0]))
    np.testing.assert_allclose(f[0, 0, 0].numpy(), f_or, atol=5e-3 * scale,
                               rtol=1e-3)


def test_padding_rows_stay_exactly_zero():
    """c_box = 0 rows (padding with garbage inputs) keep alpha exactly 0,
    and the real rows match the unpadded solve to f32 tolerance."""
    rng = np.random.RandomState(4)
    n, n_pad, d = 21, 12, 3
    x = np.zeros((1, n + n_pad, d), np.float32)
    x[0, :n] = rng.rand(n, d)
    x[0, n:] = rng.rand(n_pad, d) * 7.0
    y = np.ones((1, n + n_pad), np.float32)
    y[0, :n] = np.where(rng.rand(n) > 0.5, 1.0, -1.0)
    c_box = np.zeros((1, 1, n + n_pad), np.float32)
    c_box[0, 0, :n] = 3.0
    gamma = np.full((1, 1), 2.5, np.float32)
    a_pad, _ = ops.solve_lanes(_t(x), _t(y), _t(c_box), _t(gamma),
                               kind="rbf", n_epochs=30)
    a_ref, _ = ops.solve_lanes(_t(x[:, :n]), _t(y[:, :n]),
                               _t(c_box[:, :, :n]), _t(gamma), kind="rbf",
                               n_epochs=30)
    np.testing.assert_array_equal(a_pad[0, 0, 0, n:].numpy(), 0.0)
    np.testing.assert_allclose(a_pad[0, 0, 0, :n].numpy(),
                               a_ref[0, 0, 0].numpy(), atol=5e-4, rtol=1e-3)


def test_gram_mode_matches_blocked_oracle_on_measured_curve():
    """Gram-input mode on the hardware measured-curve Gram (the hw family's
    training kernel) vs the reference's blocked solver on the same Gram."""
    hw = ttrainer.default_hw(0)
    kernel = ttrainer._training_kernel(hw.kernel_response,
                                       torch.device("cpu"))
    x, y, c_box, gamma = _lanes(8, 2, 29, 3, 2, 3)
    kp = torch.stack([kernel(_t(x), _t(x), _t(gamma[:, g]))
                      for g in range(2)], dim=1) + 1.0
    a, f = ops.solve_lanes_gram(kp, _t(y), _t(c_box), n_epochs=20)
    for p in range(2):
        for g in range(2):
            for lane in range(3):
                kpj = jnp.asarray(kp[p, g].numpy())
                a_or = np.asarray(rtrainer.dual_coordinate_ascent_blocked(
                    kpj, jnp.asarray(y[p]), jnp.asarray(c_box[p, lane]), 20))
                np.testing.assert_allclose(a[p, g, lane].numpy(), a_or,
                                           atol=5e-4, rtol=1e-3)
                np.testing.assert_allclose(
                    f[p, g, lane].numpy(),
                    np.asarray(kpj @ (jnp.asarray(a_or) * y[p])),
                    atol=5e-3, rtol=1e-3)


def test_single_lane_blocked_solver_matches_reference():
    rng = np.random.RandomState(6)
    x = rng.rand(45, 2)
    y = np.where(rng.rand(45) > 0.5, 1.0, -1.0)
    kp = np.asarray(rkern.kernel_matrix("rbf", jnp.asarray(x, jnp.float32),
                                        jnp.asarray(x, jnp.float32), 1.5)) + 1
    c = np.full(45, 4.0)
    got = ttrainer.dual_coordinate_ascent_blocked(_t(kp), _t(y), _t(c), 15)
    want = rtrainer.dual_coordinate_ascent_blocked(
        jnp.asarray(kp, jnp.float32), jnp.asarray(y, jnp.float32),
        jnp.asarray(c, jnp.float32), 15)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                               rtol=1e-3)


# -- dispatch -----------------------------------------------------------------------


def test_cpu_tensors_run_the_plain_versions_uncounted():
    ops.reset_launches()
    x, y, c_box, gamma = _lanes(1, 1, 10, 2, 1, 1)
    ops.solve_lanes(_t(x), _t(y), _t(c_box), _t(gamma), n_epochs=2)
    ops.rbf_matrix(_t(x[0]), _t(x), _t(gamma[:, 0]))
    q = torch.zeros((1, 2, 8, 32))
    ops.flash_attention(q, q[:, :1], q[:, :1])
    qg = q.clone().requires_grad_(True)
    ops.flash_attention(qg, q[:, :1], q[:, :1]).sum().backward()
    xs = torch.zeros((1, 32, 2, 16))
    ops.ssd_scan(xs, xs[..., 0], xs[:, :, :1], xs[:, :, :1], chunk=32)
    assert ops.launch_counts() == {
        "kernel_matrix": 0, "solver": 0, "flash_attention": 0,
        "flash_attention_bf16_wgmma": 0, "flash_attention_f32_cuda_cores": 0,
        "ssd": 0, "flash_attention_bwd": 0,
        "flash_attention_bwd_bf16_wgmma": 0,
        "flash_attention_bwd_f32_cuda_cores": 0, "ssd_bwd": 0,
        "ssd_scan_backward": 0}


def test_other_devices_and_cpu_tensors_never_reach_a_kernel():
    meta = torch.empty((3, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.rbf_matrix(meta, meta[None], torch.empty(1, device="meta"))
    x = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        rbf.kernel_matrix_cuda(x, x[None], torch.ones(1))
    with pytest.raises(ValueError, match="CUDA"):
        solver.solve_lanes_cuda(x[None], torch.ones(1, 4),
                                torch.ones(1, 1, 4), torch.ones(1, 1))

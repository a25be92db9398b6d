"""The port's mesh legs of the trainer and the streamed Monte-Carlo.

On the CPU, in process, over CPU meshes of 1-4 devices
(``launch.mesh.make_*_mesh(devices=["cpu"] * n)``), mirroring
tests/test_trainer.py's ``test_trainer_mesh_requires_pairgrid_axis`` /
``test_sharded_cv_grid_matches_local`` and tests/test_mc_streaming.py's
``test_sharded_stream_matches_local`` at their shapes and tolerances:

* the sharded CV grid (cells padded with repeats of cell 0, one share per
  device) equals the port's local grid and the reference's (atol 1e-6),
  for the rbf family and the hardware-in-the-loop family (its shares cut
  into pieces under the Gram-memory gate); ``train_pairs(mesh=)`` and the
  estimator's ``mesh=`` give the local fit; a mesh without the
  ``"pairgrid"`` axis is refused;
* the sharded stream equals the port's local stream (mean, std, worst,
  best, yield atol 1e-5; hist atol 1e-3; the count exact) for iid, Sobol
  and importance sampling, and bit for bit on one device; for iid and IS,
  with the reference's ``jax.random`` draws passed in (in place of the
  port's counter draws), it equals the reference's own stream at 2 and 4
  devices (the same statistics at atol 1e-5); on the Sobol path (the
  reference's point set) its yield lies inside the reference's Wilson
  interval and its mean within 1e-3 of the reference's;
  ``monte_carlo(mesh=)`` on the estimator; a mesh without the
  ``"variants"`` axis is refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import compiled as rcompiled
from repro.core import trainer as rtrainer
from repro_torch.api import MixedKernelSVM
from repro_torch.api import compiled as tcompiled
from repro_torch.core import analog as tanalog
from repro_torch.core import trainer as ttrainer
from repro_torch.data import datasets as tds
from repro_torch.launch import mesh as mesh_mod
from test_torch_montecarlo import _tiny_candidates
from test_torch_scaleout import _port_hw_of

STATS = ("mean", "std", "worst", "best", "yield")


def _cpu(n):
    return ["cpu"] * n


# -- the trainer's mesh leg ----------------------------------------------------------


def test_trainer_mesh_requires_pairgrid_axis():
    m = mesh_mod.make_test_mesh(shape=(1,), axes=("data",))
    padded = ttrainer.pad_pairs(np.random.RandomState(0).rand(30, 2),
                                np.arange(30) % 2, 2)
    with pytest.raises(ValueError, match="pairgrid"):
        ttrainer.family_cv_grid(padded, "rbf", np.array([1.0]),
                                np.array([1.0]), 5, mesh=m)
    assert ttrainer.PAIRGRID_AXIS == "pairgrid"


@pytest.fixture(scope="module")
def grid_data():
    rng = np.random.RandomState(0)
    x = rng.rand(70, 3)
    y = rng.randint(0, 3, 70)
    gammas = np.logspace(-1, 1, 3)
    cs = np.logspace(-1, 2, 4)
    ref = rtrainer.family_cv_grid(rtrainer.pad_pairs(x, y, 3), "rbf",
                                  gammas, cs, 15)
    return x, y, gammas, cs, np.asarray(ref)


@pytest.fixture(scope="module")
def local_grid(grid_data):
    x, y, gammas, cs, _ = grid_data
    return ttrainer.family_cv_grid(ttrainer.pad_pairs(x, y, 3), "rbf",
                                   gammas, cs, 15, device="cpu")


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_sharded_cv_grid_matches_local(n_dev, grid_data, local_grid):
    """9 cells over 1-4 devices (4 pads 3 repeats of cell 0)."""
    x, y, gammas, cs, ref = grid_data
    padded = ttrainer.pad_pairs(x, y, 3)
    mesh = mesh_mod.make_trainer_mesh(devices=_cpu(n_dev))
    assert mesh.shape["pairgrid"] == n_dev
    acc_sh = ttrainer.family_cv_grid(padded, "rbf", gammas, cs, 15,
                                     mesh=mesh)
    acc_lo = local_grid
    assert acc_sh.shape == (3, 3, 4)
    np.testing.assert_allclose(acc_sh, acc_lo, atol=1e-6)
    np.testing.assert_allclose(acc_sh, ref, atol=1e-6)


def test_sharded_hw_grid_under_the_gram_gate(grid_data, monkeypatch):
    """The hardware-in-the-loop family: each share's stored Grams cut into
    pieces under ``CV_GRID_VMAP_BYTES`` give the same grid."""
    x, y, _, cs, _ = grid_data
    ref_hw = rtrainer.default_hw(0)
    hw = _port_hw_of(ref_hw)
    gammas = rtrainer.hw_gamma_grid(ref_hw)[:3]
    padded = ttrainer.pad_pairs(x, y, 3)
    lo = ttrainer.family_cv_grid(padded, hw.kernel_response, gammas, cs, 15,
                                 device="cpu")
    want = rtrainer.family_cv_grid(rtrainer.pad_pairs(x, y, 3),
                                   ref_hw.kernel_response, gammas, cs, 15)
    mesh = mesh_mod.make_trainer_mesh(devices=_cpu(2))
    monkeypatch.setattr(ttrainer, "CV_GRID_VMAP_BYTES",
                        2 * padded.n_max ** 2 * 4)
    sh = ttrainer.family_cv_grid(padded, hw.kernel_response, gammas, cs, 15,
                                 mesh=mesh)
    np.testing.assert_allclose(sh, lo, atol=1e-6)
    np.testing.assert_allclose(sh, np.asarray(want), atol=1e-6)


def test_sharded_train_pairs_matches_local_and_reference(grid_data):
    x, y, _, _, _ = grid_data
    ref_hw = rtrainer.default_hw(0)
    hw = _port_hw_of(ref_hw)
    mesh = mesh_mod.make_trainer_mesh(devices=_cpu(3))
    sh = ttrainer.train_pairs(x, y, 3, hw=hw, n_epochs=15, seed=0,
                              mesh=mesh)
    lo = ttrainer.train_pairs(x, y, 3, hw=hw, n_epochs=15, seed=0,
                              device="cpu")
    want = rtrainer.train_pairs(x, y, 3, hw=ref_hw, n_epochs=15, seed=0)
    assert len(sh) == 3
    for a, b, r in zip(sh, lo, want):
        assert a.kernel == b.kernel == r.kernel
        for slot in ("model_linear", "model_rbf"):
            ma, mb, mr = getattr(a, slot), getattr(b, slot), getattr(r, slot)
            assert (ma.gamma, ma.c) == (mb.gamma, mb.c) == (mr.gamma, mr.c)
            np.testing.assert_array_equal(ma.alpha, mb.alpha)
            np.testing.assert_allclose(ma.alpha, mr.alpha, atol=5e-4,
                                       rtol=1e-3)
        assert a.acc_rbf == b.acc_rbf


def test_estimator_mesh_fits_the_local_fit():
    ds = tds.load("balance")
    x, y = ds.x_train[:90], ds.y_train[:90]
    mesh = mesh_mod.make_trainer_mesh(devices=_cpu(2))
    est = MixedKernelSVM(n_epochs=5, cv_epochs=5, mesh=mesh).fit(x, y)
    assert est.device.type == "cpu" and est.mesh is mesh
    local = MixedKernelSVM(n_epochs=5, cv_epochs=5, device="cpu").fit(x, y)
    assert est.kernel_map_ == local.kernel_map_
    np.testing.assert_array_equal(est.predict(ds.x_test, "circuit"),
                                  local.predict(ds.x_test, "circuit"))


# -- the streamed Monte-Carlo's mesh leg --------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=40).astype(np.int32)
    return _tiny_candidates("port"), x, y, np.ones((1, 3), bool)


@pytest.mark.parametrize("method", ["iid", "sobol", "is"])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_sharded_stream_matches_local(tiny, method, n_dev):
    """37 variants in chunks of 12 (rounded up to whole per-device slices:
    12 at 1-4 devices) over 1-4 devices against the unsharded stream."""
    cands, x, y, a = tiny
    sm = tcompiled.compile_mc_stream(cands, n_classes=3, key=0, mc_chunk=12,
                                     method=method, is_scale=1.3,
                                     device="cpu")
    mesh = mesh_mod.make_variant_mesh(devices=_cpu(n_dev))
    assert mesh.shape["variants"] == n_dev
    assert sm._chunk_size(mesh) % n_dev == 0
    lo = sm.stream(x, y, a, n_variants=37, accuracy_floor=0.6)
    sh = sm.stream(x, y, a, n_variants=37, accuracy_floor=0.6, mesh=mesh)
    assert sh["count"] == 37.0
    for k in STATS:
        np.testing.assert_allclose(sh[k], lo[k], atol=1e-5, err_msg=k)
    np.testing.assert_allclose(sh["hist"], lo["hist"], atol=1e-3)
    assert sh["n_eff"] == pytest.approx(lo["n_eff"], rel=1e-5)
    if n_dev == 1:
        for k in STATS + ("hist",):
            np.testing.assert_array_equal(sh[k], lo[k], err_msg=k)


#: The tiny streams' variant count, chunk and floor (the floor splits the
#: variants, so the yield is neither 0 nor 1).
REF_V, REF_CHUNK, REF_FLOOR = 37, 12, 0.36


def _reference_draw_tables(sm, ref_sm, n_variants):
    """The reference machine's ``jax.random`` draws of variants ``0 ..
    n_variants - 1`` (its per-variant ``fold_in`` / ``split`` / ``normal``)
    for each analog bank, in the port's flat layout ``[gauss | alpha |
    comparator]``, keyed by the port bank's draw keys."""
    ng, na = tanalog.N_GAUSS_OFFSETS, tanalog.N_ALPHA_OFFSETS
    tables = {}
    for pc, rc, bank in zip(sm._stream_consts, ref_sm._stream_consts,
                            sm._kernel_banks):
        if pc is None:
            continue
        m, d = int(rc.dva.shape[1]), int(bank.sv.shape[2])

        def draw(k, idx, m=m, d=d):
            kg, ka, kc = jax.random.split(jax.random.fold_in(k, idx), 3)
            return (jax.random.normal(kg, (m, d, ng)),
                    jax.random.normal(ka, (m, na)),
                    jax.random.normal(kc, ()))

        gz, az, cz = jax.vmap(jax.vmap(draw, in_axes=(0, None)),
                              in_axes=(None, 0))(
            rc.pair_keys, jnp.arange(n_variants, dtype=jnp.int32))
        b, pb = cz.shape
        tables[tuple(pc.pair_keys.tolist())] = torch.as_tensor(
            np.concatenate([np.asarray(gz).reshape(b, pb, -1),
                            np.asarray(az).reshape(b, pb, -1),
                            np.asarray(cz).reshape(b, pb, 1)], axis=-1))
    return tables


def _port_stream(cands, method):
    return tcompiled.compile_mc_stream(cands, n_classes=3, key=5,
                                       mc_chunk=REF_CHUNK, method=method,
                                       is_scale=1.3, device="cpu")


@pytest.fixture(scope="module")
def reference_streams(tiny):
    """The reference's iid and IS streams of the tiny candidates under
    ``PRNGKey(5)``, and its draws (the same for both methods: one key)."""
    cands, x, y, a = tiny
    out = {}
    for method in ("iid", "is"):
        ref_sm = rcompiled.compile_mc_stream(
            _tiny_candidates("ref"), 3, key=jax.random.PRNGKey(5),
            method=method, mc_chunk=REF_CHUNK, is_scale=1.3)
        out[method] = ref_sm.stream(x, y, a, n_variants=REF_V,
                                    accuracy_floor=REF_FLOOR)
    # Every variant index a chunk of up to 4 device slices can ask for.
    tables = _reference_draw_tables(_port_stream(cands, "iid"), ref_sm,
                                    4 * REF_CHUNK * -(-REF_V // REF_CHUNK))
    return tables, out


@pytest.mark.parametrize("method", ["iid", "is"])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_stream_matches_reference_with_its_draws(
        tiny, reference_streams, method, n_dev, monkeypatch):
    """tests/test_mc_streaming.py::test_sharded_stream_matches_local's
    statistics at its tolerance, the port's sharded stream against the
    reference's stream, the port's counter draws replaced by the
    reference's."""
    cands, x, y, a = tiny
    tables, refs = reference_streams
    want = refs[method]

    def reference_normals(keys, v_idx, dim):
        z = tables[tuple(torch.as_tensor(keys).tolist())]
        assert z.shape[-1] == dim
        return z[v_idx].to(v_idx.device)

    monkeypatch.setattr(tcompiled, "counter_normals", reference_normals)
    got = _port_stream(cands, method).stream(
        x, y, a, n_variants=REF_V, accuracy_floor=REF_FLOOR,
        mesh=mesh_mod.make_variant_mesh(devices=_cpu(n_dev)))
    assert got["count"] == want["count"] == REF_V
    assert 0.0 < float(want["yield"][0]) < 1.0
    for k in STATS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5,
                                   err_msg=k)
    assert got["n_eff"] == pytest.approx(float(want["n_eff"]), rel=1e-5)


def test_sharded_chunk_rounds_up_to_whole_slices(tiny):
    cands, x, y, a = tiny
    sm = tcompiled.compile_mc_stream(cands, n_classes=3, key=0, mc_chunk=10,
                                     device="cpu")
    mesh = mesh_mod.make_variant_mesh(devices=_cpu(4))
    assert sm._chunk_size() == 10 and sm._chunk_size(mesh) == 12
    out = sm.stream(x, y, a, n_variants=13, accuracy_floor=0.6, mesh=mesh)
    lo = sm.stream(x, y, a, n_variants=13, accuracy_floor=0.6)
    assert out["count"] == 13.0
    np.testing.assert_allclose(out["mean"], lo["mean"], atol=1e-5)


def test_sharded_sobol_stream_within_the_references_bounds(tiny):
    """The reference's scrambled point set through the port's sharded
    stream: yield inside the reference's Wilson interval, means close
    (tests/test_torch_montecarlo.py's QMC parity)."""
    cands, x, y, a = tiny
    ref_sm = rcompiled.compile_mc_stream(_tiny_candidates("ref"), 3,
                                         key=jax.random.PRNGKey(3),
                                         method="sobol", mc_chunk=16)
    want = ref_sm.stream(x, y, a, n_variants=64, accuracy_floor=0.6)
    sm = tcompiled.compile_mc_stream(cands, n_classes=3, key=3,
                                     method="sobol", mc_chunk=16,
                                     device="cpu")
    got = sm.stream(x, y, a, n_variants=64, accuracy_floor=0.6,
                    mesh=mesh_mod.make_variant_mesh(devices=_cpu(4)))
    assert got["count"] == want["count"] == 64.0
    assert want["yield_lo"][0] <= got["yield"][0] <= want["yield_hi"][0]
    assert abs(got["mean"][0] - want["mean"][0]) < 1e-3


def test_stream_mesh_requires_variants_axis(tiny):
    cands, x, y, a = tiny
    sm = tcompiled.compile_mc_stream(cands, n_classes=3, key=0, mc_chunk=8,
                                     device="cpu")
    with pytest.raises(ValueError, match="variants"):
        sm.stream(x, y, a, n_variants=4, accuracy_floor=0.5,
                  mesh=mesh_mod.make_test_mesh())


def test_estimator_monte_carlo_mesh():
    ds = tds.load("balance")
    est = MixedKernelSVM(n_epochs=5, cv_epochs=5, device="cpu").fit(
        ds.x_train[:90], ds.y_train[:90])
    xq, yq = ds.x_test[:32], ds.y_test[:32]
    kw = dict(n_variants=20, key=4, method="iid", mc_chunk=8,
              accuracy_floor=0.5)
    lo = est.monte_carlo(xq, yq, **kw)
    sh = est.monte_carlo(xq, yq, mesh=mesh_mod.make_variant_mesh(
        devices=_cpu(2)), **kw)
    assert sh.n_variants == lo.n_variants == 20
    for k in ("mean", "std", "worst", "best", "yield_"):
        assert getattr(sh, k) == pytest.approx(getattr(lo, k), abs=1e-5), k

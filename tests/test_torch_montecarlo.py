"""The port's Monte-Carlo half (dense and streamed) against the JAX reference.

On the CPU (``device="cpu"``), with the reference's ``jax.random`` draws
passed in wherever a result depends on them:

* the dense ``MonteCarloMachine``'s bits equal the reference's wherever
  |score| > TIE_EPS, and ``mc_statistics`` of the recombined accuracies
  equal the reference's;
* inside the port: the zero-offset variant is bit for bit the nominal
  ``CandidateMachine`` (scores and bits), every variant is the object
  path's ``predict_bits_mc``, linear lanes are variation-free, the
  recombination over the variant axis equals a per-variant loop (encoder,
  votes fallback, assignment chunks);
* ``mcstream``: streamed moments, the Wilson / Clopper-Pearson bounds and
  ``hist_quantiles`` against the reference (atol 1e-6);
* the streaming machine: streamed statistics equal its own dense oracle,
  chunk edges and chunk-size invariance, the Sobol path deterministic from
  the seed with the reference's point set (its statistics within the
  reference's Wilson bounds), ``is_scale=1`` degenerating to iid, and the
  importance-sampled yield equal to the brute-force weighted estimate;
* estimators: the Monte-Carlo sweep, robust selection, yield deploys, and
  a reference save carrying ``assignment`` and ``monte_carlo`` state
  loading in the port and deploying the same assignment.

Tolerances: the reference's own (tests/test_mc_streaming.py: moments
1e-4 against the dense oracle, 2e-6 across chunkings).
"""
import jax
import numpy as np
import pytest
import torch

from repro.api import MixedKernelSVM as RefSVM
from repro.api import compiled as rcompiled
from repro.core import dse as rdse
from repro.core import mcstream as rmc
from repro.core import trainer as rtrainer
from repro.core.analog import AnalogBinaryClassifier as RefAnalog
from repro.core.svm import SVMModel as RefModel
from repro.data import datasets as rds
from repro_torch.api import MixedKernelSVM
from repro_torch.api import compiled as tcompiled
from repro_torch.core import analog as tanalog
from repro_torch.core import dse as tdse
from repro_torch.core import mcstream as tmc
from repro_torch.core import svm as tsvm

TIE_EPS = 1e-5
FIT = dict(n_epochs=40, cv_epochs=20, seed=0)
MOMENT_TOL = 1e-4
CPU = dict(device="cpu")


def _port_hw_of(ref_hw):
    return tanalog.AnalogRBFModel(
        tanalog.CircuitParams(), ref_hw.dv_grid, ref_hw.kernel_curve,
        ref_hw.a0, ref_hw.gamma0, ref_hw.mu, ref_hw.alpha_x0, ref_hw.alpha_s,
        ref_hw.dva_grid, ref_hw.alpha_curve, ref_hw.v_scale)


def _port_variants(v):
    """A reference ``VariantSet`` as the port's."""
    return tanalog.VariantSet(*(torch.as_tensor(np.array(a)) for a in
                                (v.gauss, v.alpha, v.comparator)))


def _reference_draws(cands, seed, n_variants):
    """The reference's per-pair draws of
    ``compile_variants(key=PRNGKey(seed))``."""
    keys = jax.random.split(jax.random.PRNGKey(seed), len(cands))
    return [_port_variants(clf.sample_variants(keys[p], n_variants))
            for p, (_, clf) in enumerate(cands)]


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    ds = rds.load("balance")
    idx = np.random.RandomState(0).permutation(len(ds.y_train))[:150]
    ref = RefSVM(use_pallas=False, **FIT).fit(ds.x_train[idx],
                                              ds.y_train[idx])
    path = str(tmp_path_factory.mktemp("est") / "balance")
    ref.save(path)
    port = MixedKernelSVM.load(path, device="cpu", hw=_port_hw_of(ref.hw_))
    return ref, port, ds


# -- the dense variant machine against the reference --------------------------------


def test_pair_bits_with_reference_draws(fitted):
    ref, port, ds = fitted
    v = 16
    ref_m = ref.monte_carlo_machine(v, jax.random.PRNGKey(0))
    draws = _reference_draws(ref._candidates(), 0, v)
    m = tcompiled.compile_variants(port._candidates(), 3, draws=draws,
                                   n_variants=v, **CPU)
    x = ds.x_test
    scores, want = ref_m.pair_scores(x), ref_m.pair_bits(x)
    bits = m.pair_bits(x)
    assert bits.shape == (v, len(x), 3, 2) and m.key_data is None
    clear = np.abs(scores) > TIE_EPS
    np.testing.assert_array_equal(bits[clear], want[clear])
    np.testing.assert_allclose(m.pair_scores(x), scores, atol=1e-4)
    a = rdse.enumerate_assignments(3)
    acc = tdse.assignment_accuracies_mc(bits, a, ds.y_test, 3, **CPU)
    ref_acc = rdse.assignment_accuracies_mc(want, a, ds.y_test, 3)
    np.testing.assert_array_equal(acc, ref_acc)
    for floor in (0.8, 0.9):
        got, exp = (tdse.mc_statistics(acc, floor),
                    rdse.mc_statistics(ref_acc, floor))
        for k in exp:
            np.testing.assert_array_equal(got[k], exp[k], err_msg=k)


def test_object_path_with_reference_draws(fitted):
    """The port's ``predict_bits_mc`` under the reference's draws: the
    reference's object-path bits off ties."""
    ref, port, ds = fitted
    (_, rclf), (_, tclf) = ref._candidates()[0], port._candidates()[0]
    rv = rclf.sample_variants(jax.random.PRNGKey(11), 3)
    margin = np.asarray(rclf.decision_mc(ds.x_test, rv))
    want = (margin >= 0.0).astype(np.int32)         # its predict_bits_mc
    got = tclf.decision_mc(ds.x_test, _port_variants(rv), "cpu").numpy()
    np.testing.assert_allclose(got, margin, atol=1e-4)
    clear = np.abs(margin) > TIE_EPS
    np.testing.assert_array_equal((got >= 0.0)[clear], want[clear])


# -- contracts inside the port -----------------------------------------------------


@pytest.fixture(scope="module")
def mc_machine(fitted):
    _, port, _ = fitted
    return port.monte_carlo_machine(16, 3)


def test_zero_offset_variant_bit_identical_to_nominal(fitted, mc_machine):
    _, port, ds = fitted
    nominal = tcompiled.compile_candidates(port._candidates(), 3, **CPU)
    for x in (ds.x_train, ds.x_test):
        np.testing.assert_array_equal(mc_machine.pair_scores(x)[0],
                                      nominal.pair_scores(x))
        np.testing.assert_array_equal(mc_machine.pair_bits(x)[0],
                                      nominal.pair_bits(x))


def test_explicit_zero_draws_through_the_variant_lanes(fitted):
    """All-zero draws WITHOUT the nominal shortcut: every kernel value of
    the variant lanes subtracts an exact 0 and multiplies by an exact 1."""
    _, port, ds = fitted
    bank = port.design_space().machine._kernel_banks[0]
    x = torch.as_tensor(ds.x_test, dtype=torch.float32)
    z = torch.zeros((2,) + tuple(bank.sv.shape))
    got = tcompiled._pair_kernel(bank, x, z, z + 1.0)
    want = tcompiled._pair_kernel(bank, x)
    assert torch.equal(got[0], want) and torch.equal(got[1], want)


def test_variants_match_object_path(fitted):
    _, port, ds = fitted
    cands = port._candidates()
    m = tcompiled.compile_variants(cands, 3, key=11, n_variants=8, **CPU)
    bits = m.pair_bits(ds.x_test)
    scores = m.pair_scores(ds.x_test)
    for p, (_, clf) in enumerate(cands):
        variants = clf.sample_variants(tanalog.stream_key(11, p), 8,
                                       device="cpu")
        want = clf.predict_bits_mc(ds.x_test, variants, "cpu")
        clear = np.abs(scores[:, :, p, 1]) > TIE_EPS
        np.testing.assert_array_equal(bits[:, :, p, 1][clear], want[clear])


def test_linear_lanes_are_variation_free(fitted, mc_machine):
    _, _, ds = fitted
    scores = mc_machine.pair_scores(ds.x_test)
    for v in range(1, scores.shape[0]):
        np.testing.assert_array_equal(scores[v, :, :, 0], scores[0, :, :, 0])
    assert np.abs(scores[1:, :, :, 1] - scores[:1, :, :, 1]).max() > 0


def test_accuracies_mc_match_per_variant_loop(fitted, mc_machine):
    _, _, ds = fitted
    bits3 = mc_machine.pair_bits(ds.x_test)
    a = tdse.enumerate_assignments(3)
    acc = tdse.assignment_accuracies_mc(bits3, a, ds.y_test, 3, **CPU)
    for v in range(bits3.shape[0]):
        np.testing.assert_array_equal(
            acc[v], tdse.assignment_accuracies(bits3[v], a, ds.y_test, 3,
                                               **CPU))
    np.testing.assert_array_equal(
        tdse.assignment_accuracies_mc(bits3, a, ds.y_test, 3,
                                      max_table_bits=0, **CPU), acc)
    for chunk in (1, 3, 5):
        np.testing.assert_array_equal(tdse.assignment_accuracies_mc(
            bits3, a, ds.y_test, 3, mc_chunk=chunk, **CPU), acc)
    with pytest.raises(ValueError, match="mc_chunk"):
        tdse.assignment_accuracies_mc(bits3, a, ds.y_test, 3, mc_chunk=0,
                                      **CPU)


def test_accuracies_mc_chunked_path_matches_reference():
    rng = np.random.RandomState(0)
    bits3 = rng.randint(0, 2, (3, 60, 10, 2)).astype(np.int32)
    y = rng.randint(0, 5, 60)
    a = tdse.enumerate_assignments(10)        # 1024 > MC_CHUNK
    np.testing.assert_array_equal(
        tdse.assignment_accuracies_mc(bits3, a, y, 5, **CPU),
        rdse.assignment_accuracies_mc(bits3, a, y, 5))


# -- the accumulator / bound / sketch layer against the reference ------------------


def test_stream_moments_match_reference():
    rng = np.random.default_rng(0)
    acc = rng.uniform(0.3, 1.0, size=(48, 2)).astype(np.float32)
    w = rng.uniform(0.1, 3.0, size=48).astype(np.float32)
    valid = np.ones(48, np.float32)
    valid[-5:] = 0.0
    rs = rmc.init_stream(2, rmc.hist_bins(100))
    ts = tmc.init_stream(2, tmc.hist_bins(100), "cpu")
    for s in range(0, 48, 16):
        sl = slice(s, s + 16)
        rs = rmc.update_stream(rs, acc[sl], w[sl], valid[sl],
                               np.float32(0.6))
        ts = tmc.update_stream(ts, torch.as_tensor(acc[sl]),
                               torch.as_tensor(w[sl]),
                               torch.as_tensor(valid[sl]), 0.6)
    got, want = tmc.finalize(ts), rmc.finalize(rs)
    for k in ("mean", "std", "worst", "best", "yield", "yield_lo",
              "yield_hi", "count", "n_eff"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    np.testing.assert_allclose(ts.hist.numpy(), np.asarray(rs.hist),
                               atol=1e-6)
    m = valid > 0
    wm = (w[m, None] * acc[m]).sum(0) / w[m].sum()
    np.testing.assert_allclose(got["mean"], wm, atol=1e-5)


def test_stream_log_scales_match_reference():
    """Importance-sampling log-scales far from zero merge as the
    reference merges them."""
    rng = np.random.default_rng(1)
    rs = rmc.init_stream(3, 11)
    ts = tmc.init_stream(3, 11, "cpu")
    for ref_scale in (-300.0, -250.0, -320.0):
        acc = rng.uniform(0.0, 1.0, (8, 3)).astype(np.float32)
        w = rng.uniform(0.01, 1.0, 8).astype(np.float32)
        valid = np.ones(8, np.float32)
        rs = rmc.update_stream(rs, acc, w, valid, np.float32(0.5),
                               log_ref=np.float32(ref_scale))
        ts = tmc.update_stream(ts, torch.as_tensor(acc), torch.as_tensor(w),
                               torch.as_tensor(valid), 0.5,
                               log_ref=torch.tensor(ref_scale))
    got, want = tmc.finalize(ts), rmc.finalize(rs)
    for k in ("mean", "std", "yield", "n_eff"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


@pytest.mark.parametrize("p,n", [(1.0, 64), (0.0, 64), (0.5, 100),
                                 (0.9, 100), (0.37, 17.5)])
def test_binomial_bounds_match_reference(p, n):
    for name in ("wilson_bounds", "clopper_pearson_bounds"):
        got = getattr(tmc, name)(p, n)
        want = getattr(rmc, name)(p, n)
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)


def test_hist_quantiles_match_reference():
    rng = np.random.default_rng(2)
    hist = rng.integers(0, 5, (4, 21)).astype(np.float64)
    qs = np.array([0.0, 0.1, 0.5, 0.9, 1.0])
    np.testing.assert_allclose(tmc.hist_quantiles(hist, qs),
                               rmc.hist_quantiles(hist, qs), atol=1e-6)


# -- the streaming machine --------------------------------------------------------


def _tiny_candidates(pkg, m=6, d=3):
    """tests/test_mc_streaming.py::_tiny_candidates in either package,
    both around the reference's calibrated core."""
    ref_hw = rtrainer.default_hw(0)
    if pkg == "ref":
        model, analog, hw = RefModel, RefAnalog, ref_hw
    else:
        model, analog, hw = (tsvm.SVMModel, tanalog.AnalogBinaryClassifier,
                             _port_hw_of(ref_hw))
    rng = np.random.default_rng(0)
    sx = rng.normal(size=(m, d)).astype(np.float32)
    sy = (np.arange(m) % 2 * -2 + 1).astype(np.float32)
    alpha = (np.abs(rng.normal(size=m)) + 0.1).astype(np.float32)
    w = ((alpha * sy) @ sx).astype(np.float32)
    lin = model(kind="linear", support_x=sx, support_y=sy, alpha=alpha,
                bias=0.1, gamma=1.0, c=1.0, w=w)
    rbf = model(kind="rbf", support_x=sx, support_y=sy, alpha=alpha,
                bias=-0.05, gamma=0.7, c=1.0)
    hw_clf = analog.deploy(rbf, hw)
    hw_small = analog.deploy(
        model(kind="rbf", support_x=sx[:4], support_y=sy[:4],
              alpha=alpha[:4], bias=0.02, gamma=0.9, c=1.0), hw)
    return [(lin, rbf), (lin, hw_clf), (lin, hw_small)]


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=40).astype(np.int32)
    return _tiny_candidates("port"), x, y, np.ones((1, 3), bool)


def _stream(cands, chunk=8, **kw):
    return tcompiled.compile_mc_stream(cands, n_classes=3, mc_chunk=chunk,
                                       **kw, **CPU)


def _dense(sm, x, y, a, n_variants, chunk=8):
    bits = np.concatenate([
        sm.pair_bits_dense(x, np.arange(s, min(s + chunk, n_variants)))
        for s in range(0, n_variants, chunk)])
    return tdse.assignment_accuracies_mc(bits, a, y, 3, **CPU)


@pytest.mark.parametrize("n_variants", [1, 8, 9, 21])
def test_streamed_matches_dense_oracle(tiny, n_variants):
    cands, x, y, a = tiny
    sm = _stream(cands, key=0)
    out = sm.stream(x, y, a, n_variants=n_variants, accuracy_floor=0.6)
    acc = _dense(sm, x, y, a, n_variants)
    assert out["count"] == float(n_variants)
    assert abs(out["mean"][0] - acc.mean()) < MOMENT_TOL
    assert abs(out["std"][0] - acc.std()) < MOMENT_TOL
    assert out["worst"][0] == acc.min() and out["best"][0] == acc.max()
    assert out["yield"][0] == (acc >= 0.6).mean()


def test_multi_assignment_columns(tiny):
    cands, x, y, _ = tiny
    a = np.array([[1, 1, 1], [0, 0, 0], [1, 0, 1]], bool)
    sm = _stream(cands, key=0)
    out = sm.stream(x, y, a, n_variants=17, accuracy_floor=0.5)
    acc = _dense(sm, x, y, a, 17)
    np.testing.assert_allclose(out["mean"], acc.mean(0), atol=MOMENT_TOL)
    np.testing.assert_array_equal(out["worst"], acc.min(0))
    np.testing.assert_array_equal(out["yield"], (acc >= 0.5).mean(0))


@pytest.mark.parametrize("method", ["iid", "sobol"])
def test_chunk_size_invariance(tiny, method):
    cands, x, y, a = tiny
    outs = [_stream(cands, chunk, key=0, method=method).stream(
        x, y, a, n_variants=21, accuracy_floor=0.6) for chunk in (5, 8, 32)]
    for out in outs[1:]:
        for k in ("mean", "std", "worst", "best", "yield", "yield_lo"):
            np.testing.assert_allclose(out[k], outs[0][k], atol=2e-6)
        np.testing.assert_array_equal(out["hist"], outs[0]["hist"])


def test_stream_rejects_bad_config(tiny):
    cands, x, y, a = tiny
    with pytest.raises(ValueError, match="method"):
        _stream(cands, key=0, method="mcmc")
    with pytest.raises(ValueError, match="mc_chunk"):
        _stream(cands, 0, key=0)
    sm = _stream(cands, key=0)
    with pytest.raises(ValueError, match="n_variants"):
        sm.stream(x, y, a, n_variants=0, accuracy_floor=0.5)
    with pytest.raises(ValueError, match="variants"):
        sm.stream(x, y, a, n_variants=4, accuracy_floor=0.5, mesh=object())


def test_sobol_deterministic_and_the_references_point_set(tiny):
    cands, x, y, a = tiny
    out1 = _stream(cands, key=7, method="sobol").stream(
        x, y, a, n_variants=24, accuracy_floor=0.6)
    out2 = _stream(cands, key=7, method="sobol").stream(
        x, y, a, n_variants=24, accuracy_floor=0.6)
    np.testing.assert_array_equal(out1["hist"], out2["hist"])
    assert out1["mean"][0] == out2["mean"][0]
    out4 = _stream(cands, key=8, method="sobol").stream(
        x, y, a, n_variants=24, accuracy_floor=0.6)
    assert not np.array_equal(out4["hist"], out1["hist"])
    # the same scrambled point set as the reference's, chunk by chunk
    sm = _stream(cands, key=7, method="sobol")
    ref_sm = rcompiled.compile_mc_stream(_tiny_candidates("ref"), 3,
                                         key=jax.random.PRNGKey(7),
                                         method="sobol", mc_chunk=8)
    assert (sm.mismatch_dim, sm.true_dim) == (ref_sm.mismatch_dim,
                                              ref_sm.true_dim)
    for start in (0, 8, 40):
        np.testing.assert_array_equal(sm._sampler.chunk(start, 8),
                                      ref_sm._sampler.chunk(start, 8))


@pytest.mark.parametrize("method", ["sobol", "stratified"])
def test_qmc_statistics_within_reference_wilson_bounds(tiny, method):
    """The same uniforms through the port (its inverse CDF may differ by
    ulps): yield inside the reference's Wilson interval, means close."""
    cands, x, y, a = tiny
    ref_sm = rcompiled.compile_mc_stream(_tiny_candidates("ref"), 3,
                                         key=jax.random.PRNGKey(3),
                                         method=method, mc_chunk=16)
    want = ref_sm.stream(x, y, a, n_variants=64, accuracy_floor=0.6)
    got = _stream(cands, 16, key=3, method=method).stream(
        x, y, a, n_variants=64, accuracy_floor=0.6)
    assert want["yield_lo"][0] <= got["yield"][0] <= want["yield_hi"][0]
    assert abs(got["mean"][0] - want["mean"][0]) < 1e-3


def test_sobol_dense_oracle_parity(tiny):
    cands, x, y, a = tiny
    sm = _stream(cands, key=3, method="sobol")
    out = sm.stream(x, y, a, n_variants=16, accuracy_floor=0.6)
    acc = _dense(sm, x, y, a, 16)
    assert abs(out["mean"][0] - acc.mean()) < MOMENT_TOL
    assert out["worst"][0] == acc.min()
    assert out["yield"][0] == (acc >= 0.6).mean()


def test_is_scale_one_degenerates_to_iid(tiny):
    cands, x, y, a = tiny
    iid = _stream(cands, key=0)
    is1 = _stream(cands, key=0, method="is", is_scale=1.0)
    np.testing.assert_allclose(is1.chunk_weights(np.arange(8)), 1.0,
                               atol=1e-5)
    o1 = iid.stream(x, y, a, n_variants=20, accuracy_floor=0.6)
    o2 = is1.stream(x, y, a, n_variants=20, accuracy_floor=0.6)
    np.testing.assert_allclose(o2["mean"], o1["mean"], atol=2e-6)
    np.testing.assert_array_equal(o2["worst"], o1["worst"])
    assert o2["n_eff"] == pytest.approx(o1["n_eff"], rel=1e-4)


def test_is_yield_matches_brute_force_weighted_estimate(tiny):
    cands, x, y, a = tiny
    sm = _stream(cands, key=0, method="is", is_scale=1.3)
    floor, v = 0.6, 24
    out = sm.stream(x, y, a, n_variants=v, accuracy_floor=floor)
    acc = _dense(sm, x, y, a, v)[:, 0]
    w = np.concatenate([sm.chunk_weights(np.arange(s, s + 8))
                        for s in range(0, v, 8)])
    assert np.isfinite(w).all() and w.min() > 0
    assert out["yield"][0] == pytest.approx(
        float((w * (acc >= floor)).sum() / w.sum()), abs=1e-5)
    assert out["mean"][0] == pytest.approx(
        float((w * acc).sum() / w.sum()), abs=1e-4)
    assert out["n_eff"] == pytest.approx(
        float(w.sum() ** 2 / (w * w).sum()), rel=1e-3)


def test_variant_dim_layout_matches_reference(tiny):
    cands, _, _, _ = tiny
    sm = _stream(cands, key=0)
    assert sm.true_dim == tanalog.variant_dim(6, 3) + \
        tanalog.variant_dim(4, 3)
    z = torch.arange(2 * tanalog.variant_dim(4, 3), dtype=torch.float32
                     ).reshape(2, -1)
    from repro.core.analog import variant_set_from_flat as ref_flat
    got = tanalog.variant_set_from_flat(z, 4, 3, 0.5)
    want = ref_flat(jax.numpy.asarray(z.numpy()), 4, 3, 0.5)
    for f in ("gauss", "alpha", "comparator"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def test_variant_transfer_params_match_reference():
    from repro.core import analog as ranalog

    rng = np.random.default_rng(4)
    raw = [rng.normal(size=s).astype(np.float32)
           for s in ((5, 6, 3, 4), (5, 6, 2), (5,))]
    raw[0][0] = raw[1][0] = raw[2][0] = 0.0
    got = tanalog.variant_transfer_params(
        tanalog.VariantSet(*map(torch.as_tensor, raw)),
        tanalog.CircuitParams())
    want = ranalog.variant_transfer_params(
        ranalog.VariantSet(*map(jax.numpy.asarray, raw)),
        ranalog.CircuitParams())
    for f in ("shift", "gain", "alpha_shift", "alpha_slope", "comp_offset"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=2e-7, atol=1e-12, err_msg=f)
    # the zero row reduces to exact identities
    assert float(got.gain[0].min()) == float(got.gain[0].max()) == 1.0
    assert float(got.alpha_slope[0].min()) == 1.0


def test_counter_draws_are_pure_functions_of_key_and_index():
    full = tanalog.counter_normals(tanalog.stream_key(5, 2),
                                   torch.arange(40), 33)
    part = tanalog.counter_normals(tanalog.stream_key(5, 2),
                                   torch.arange(17, 29), 33)
    assert torch.equal(full[17:29], part)
    other = tanalog.counter_normals(tanalog.stream_key(5, 3),
                                    torch.arange(40), 33)
    assert not torch.equal(full, other)
    assert abs(float(full.mean())) < 0.1 and abs(float(full.std()) - 1) < 0.1


# -- estimators ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def mc_sweep(fitted):
    _, port, ds = fitted
    return port.pareto(ds.x_test, ds.y_test, n_variants=16, key=0,
                       accuracy_floor=0.85)


def test_mc_sweep_fields(fitted, mc_sweep):
    _, port, _ = fitted
    sw = mc_sweep
    assert sw.is_monte_carlo and sw.exhaustive
    assert sw.accuracy_mc.shape == (16, 8)
    np.testing.assert_array_equal(sw.accuracy, sw.accuracy_mc[0])
    i = sw.find(np.zeros(3, bool))
    assert sw.acc_std[i] == 0.0 and sw.yield_[i] in (0.0, 1.0)
    assert (sw.yield_at(0.5) >= sw.yield_).all()
    assert sw.mc_key_data.tolist() == [0, 0]
    assert port.mc_state_ == {"key_data": [0, 0], "n_variants": 16,
                              "sigma_scale": 1.0, "accuracy_floor": 0.85}


def test_yield_floor_rules(fitted, mc_sweep):
    _, port, ds = fitted
    sw = mc_sweep
    floor = float(sw.yield_[sw.robust_front].max())
    port.deploy("circuit", yield_floor=floor, yield_confidence=None)
    i = sw.find(tdse.assignment_from_kernel_map(port.assignment_))
    assert sw.yield_[i] >= floor
    assert port.mc_state_["yield_confidence"] is None
    with pytest.raises(ValueError, match="yield"):
        port.deploy("circuit", yield_floor=1.1)
    nominal = port.design_space().sweep(ds.x_test, ds.y_test)
    with pytest.raises(RuntimeError, match="Monte-Carlo"):
        nominal.select(yield_floor=0.9)
    with pytest.raises(ValueError, match="n_variants"):
        port.pareto(ds.x_test, ds.y_test, accuracy_floor=0.9)
    port.assignment_ = None


def test_monte_carlo_results(fitted):
    _, port, ds = fitted
    mc = port.monte_carlo(ds.x_test, ds.y_test, n_variants=16, key=5)
    assert mc.accuracy.shape == (16,)
    assert mc.nominal == pytest.approx(
        port.score(ds.x_test, ds.y_test, target="circuit"), abs=1e-6)
    assert mc.worst <= mc.mean <= 1.0 and mc.key_data == [0, 5]
    mc0 = port.monte_carlo(ds.x_test, ds.y_test, n_variants=4, key=5,
                           sigma_scale=0.0)
    assert mc0.std == 0.0 and mc0.mean == mc0.nominal
    lin = port.monte_carlo(ds.x_test, ds.y_test, n_variants=4, key=5,
                           assignment=np.zeros(3, bool))
    assert lin.assignment == ["linear"] * 3 and lin.std == 0.0
    st = port.monte_carlo(ds.x_test[:64], ds.y_test[:64], n_variants=40,
                          key=5, method="sobol", mc_chunk=16)
    assert st.n_variants == 40 and st.method == "sobol"
    assert st.yield_lo <= st.yield_ <= st.yield_hi
    assert st.worst <= st.quantile(0.5) <= st.best


def test_reference_mc_save_loads_in_port(fitted, tmp_path):
    ref, _, ds = fitted
    sw = ref.pareto(ds.x_test, ds.y_test, n_variants=16,
                    key=jax.random.PRNGKey(0), accuracy_floor=0.8)
    ref.deploy("circuit", yield_floor=float(sw.yield_[sw.robust_front].max()),
               yield_confidence=None)
    path = str(tmp_path / "ref")
    ref.save(path)
    want = ref.deploy_assignment()
    port = MixedKernelSVM.load(path, device="cpu", hw=_port_hw_of(ref.hw_))
    assert port.assignment_ == ref.assignment_
    assert port.mc_state_ == ref.mc_state_
    assert port.mc_state_["key_data"] == [0, 0]
    ref.assignment_ = None
    scores = want.decision_scores(ds.x_test)
    clear = np.abs(scores) > TIE_EPS
    np.testing.assert_array_equal(
        port.deploy_assignment().predict_bits(ds.x_test)[clear],
        want.predict_bits(ds.x_test)[clear])
    # the stored key data seeds the port's own draws
    m = port.monte_carlo_machine(port.mc_state_["n_variants"],
                                 port.mc_state_["key_data"])
    assert m.key_data.tolist() == [0, 0]
    assert m is port.monte_carlo_machine(16, 0)


def test_port_mc_save_roundtrip(fitted, tmp_path):
    ref, _, ds = fitted
    path = str(tmp_path / "ref")
    ref.save(path)
    from test_torch_dse import _reference_offsets

    port = MixedKernelSVM.load(path, device="cpu",
                               hw_offsets=_reference_offsets())
    sw = port.pareto(ds.x_test, ds.y_test, n_variants=8, key=2,
                     accuracy_floor=0.8)
    port.deploy("circuit", yield_floor=float(sw.yield_[sw.robust_front].max()),
                yield_confidence=None)
    out = str(tmp_path / "port")
    port.save(out)
    again = MixedKernelSVM.load(out, device="cpu",
                                hw_offsets=_reference_offsets())
    assert again.assignment_ == port.assignment_
    assert again.mc_state_ == port.mc_state_
    np.testing.assert_array_equal(
        again.monte_carlo_machine(8, again.mc_state_["key_data"]).pair_bits(
            ds.x_test), port.monte_carlo_machine(8, 2).pair_bits(ds.x_test))
    back = RefSVM.load(out, use_pallas=False)
    assert back.mc_state_ == port.mc_state_

"""The port's K >= 10 scale-out trainer against the JAX reference.

On the CPU (``device="cpu"``), at the shapes of tests/test_trainer.py:

* ``PaddedPairs.take`` / ``trim`` equal the reference's, array for array;
* ``shard_lane_layout`` returns the reference's partition (same shards,
  same order) for d in {1, 2, 4, 8, 20}, on a ladder of sizes and on
  har12's 66 subset sizes; the shards partition the pairs and the makespan
  never worsens with more shards;
* ``family_cv_grid`` / ``family_refit`` equal the reference's (CV
  accuracies atol 1e-6; alphas atol 5e-4, rtol 1e-3);
* ``family_cv_grid_size_sharded(devices=["cpu"] * 3)`` equals
  ``family_cv_grid`` within atol 1e-6;
* the Gram-memory gate (``_seq_gamma``) engages at (66, 1582, 5) x 7 and
  not at UCI shapes, and the gated hw grid (one launch per gamma) equals
  the stacked one;
* ``train_pairs_sequential`` agrees with ``train_pairs`` on the 150-row
  Balance subsample: the same kernel map and (gamma, C), alphas within
  atol 5e-4 / rtol 1e-3 (hw 5e-3);
* ``explore`` warns and matches ``build_banks``;
* ``train_pairs_sequential`` and ``explore`` equal the reference's own on
  the same inputs and behavioral model: the same kernel map, (gamma, C)
  and support sets, alphas within atol 5e-4 / rtol 1e-3 (hw 5e-3), and
  the same accuracy of every design point.
"""
import numpy as np
import pytest

from repro.core import trainer as rtrainer
from repro_torch.core import analog as tanalog
from repro_torch.core import selection as tselection
from repro_torch.core import trainer as ttrainer
from repro_torch.data import datasets as tds
from repro_torch.kernels import ops as kops

GAMMAS = np.array([0.5, 2.0])
CS = np.array([1.0, 10.0])


def _both_padded(n=90, k=4, n_folds=4, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3)
    y = rng.randint(0, k, n)
    return (rtrainer.pad_pairs(x, y, k, n_folds=n_folds, seed=0),
            ttrainer.pad_pairs(x, y, k, n_folds=n_folds, seed=0))


def _assert_same_stack(got, want):
    assert got.pairs == want.pairs
    assert got.n_true == want.n_true
    assert got.n_max == want.n_max
    for name in ("x", "y", "valid", "fold_masks"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for (xg, yg), (xw, yw) in zip(got.subsets, want.subsets):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)


def _port_hw_of(ref_hw):
    """The port's behavioral model with the reference model's fields."""
    return tanalog.AnalogRBFModel(
        tanalog.CircuitParams(), ref_hw.dv_grid, ref_hw.kernel_curve,
        ref_hw.a0, ref_hw.gamma0, ref_hw.mu, ref_hw.alpha_x0, ref_hw.alpha_s,
        ref_hw.dva_grid, ref_hw.alpha_curve, ref_hw.v_scale)


# -- take / trim ------------------------------------------------------------------


def test_take_and_trim_equal_reference():
    ref, port = _both_padded()
    shards = ttrainer.shard_lane_layout(port.n_true, 3)
    maxima = set()
    for s in shards:
        idx = [int(i) for i in s]
        _assert_same_stack(port.take(idx), ref.take(idx))
        got, want = port.take(idx).trim(), ref.take(idx).trim()
        _assert_same_stack(got, want)
        assert got.n_max == max(port.n_true[i] for i in idx)
        maxima.add(got.n_max)
    assert len(maxima) > 1                    # shard maxima actually differ
    assert port.trim() is port                # already at its own max
    sub = port.take([2])
    assert sub.pairs == [port.pairs[2]] and sub.x.shape[0] == 1


# -- shard_lane_layout ------------------------------------------------------------

SIZES = [198, 220, 300, 420, 500, 640, 800, 1000, 1200, 1400, 1582, 1582]


def _makespan(sizes, shards):
    return max(len(s) * int(max(np.asarray(sizes)[s])) ** 2 for s in shards)


@pytest.mark.parametrize("d", [1, 2, 4, 8, 20])
def test_shard_lane_layout_equals_reference(d):
    got = ttrainer.shard_lane_layout(SIZES, d)
    want = rtrainer.shard_lane_layout(SIZES, d)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 1 <= len(got) <= max(1, min(d, len(SIZES)))
    np.testing.assert_array_equal(np.sort(np.concatenate(got)),
                                  np.arange(len(SIZES)))


def test_shard_lane_layout_makespan_never_worsens():
    prev = None
    for d in (1, 2, 4, 8, 20):
        m = _makespan(SIZES, ttrainer.shard_lane_layout(SIZES, d))
        if prev is not None:
            assert m <= prev
        prev = m
    assert len(ttrainer.shard_lane_layout(SIZES, 1)) == 1
    assert ttrainer.shard_lane_layout([], 4) == []


def test_shard_lane_layout_on_har12_equals_reference():
    """har12's 66 subset sizes (198..1582): the reference's partition at
    every rung of the lane ladder, and the padded / true solver work
    falling from 3.86x at one shard to 1.17x at eight."""
    ds = tds.load("har12")
    n_true = [int(((ds.y_train == i) | (ds.y_train == j)).sum())
              for i, j in ttrainer.class_pairs(ds.n_classes)]
    assert (min(n_true), max(n_true)) == (198, 1582)
    true = sum(n * n for n in n_true)
    ratios = []
    for d in (1, 2, 4, 8):
        got = ttrainer.shard_lane_layout(n_true, d)
        want = rtrainer.shard_lane_layout(n_true, d)
        assert [list(g) for g in got] == [list(w) for w in want]
        padded = sum(len(s) * max(n_true[i] for i in s) ** 2 for s in got)
        ratios.append(padded / true)
    np.testing.assert_allclose(ratios, [3.86, 2.01, 1.43, 1.17], atol=0.005)


# -- family_cv_grid / family_refit -------------------------------------------------


@pytest.mark.parametrize("kind", ["linear", "rbf"])
def test_family_cv_grid_and_refit_equal_reference(kind):
    ref, port = _both_padded()
    g = np.array([1.0]) if kind == "linear" else GAMMAS
    want = rtrainer.family_cv_grid(ref, kind, g, CS, 15, use_pallas=False)
    got = ttrainer.family_cv_grid(port, kind, g, CS, 15, device="cpu")
    assert got.shape == want.shape == (port.n_pairs, len(g), len(CS))
    np.testing.assert_allclose(got, want, atol=1e-6)
    gi = np.arange(port.n_pairs) % len(g)
    ci = (np.arange(port.n_pairs) + 1) % len(CS)
    a_want = rtrainer.family_refit(ref, kind, g[gi], CS[ci], 20,
                                   use_pallas=False)
    a_got = ttrainer.family_refit(port, kind, g[gi], CS[ci], 20, device="cpu")
    assert a_got.shape == (port.n_pairs, port.n_max)
    np.testing.assert_allclose(a_got, a_want, atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(a_got[port.valid == 0], 0.0)


def test_family_cv_grid_hw_equals_reference():
    ref, port = _both_padded()
    ref_hw = rtrainer.default_hw(0)
    port_hw = _port_hw_of(ref_hw)
    g = rtrainer.hw_gamma_grid(ref_hw, 3)
    want = rtrainer.family_cv_grid(ref, ref_hw.kernel_response, g, CS, 15,
                                   use_pallas=False)
    got = ttrainer.family_cv_grid(port, port_hw.kernel_response, g, CS, 15,
                                  device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("kind", ["rbf", "hw"])
def test_size_sharded_grid_equals_family_grid(kind):
    _, port = _both_padded()
    if kind == "hw":
        hw = ttrainer.default_hw(0)
        kind, g = hw.kernel_response, ttrainer.hw_gamma_grid(hw, 2)
    else:
        g = GAMMAS
    want = ttrainer.family_cv_grid(port, kind, g, CS, 15, device="cpu")
    got = ttrainer.family_cv_grid_size_sharded(port, kind, g, CS, 15,
                                               devices=["cpu"] * 3)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_size_sharded_grid_five_classes_equals_reference():
    """tests/test_trainer.py::test_size_sharded_grid_8_devices's shapes:
    up to 8 shards of K = 5's ten pairs against the reference's grid."""
    rng = np.random.RandomState(0)
    x = rng.rand(120, 3)
    y = rng.randint(0, 5, 120)
    ref = rtrainer.pad_pairs(x, y, 5, n_folds=4, seed=0)
    port = ttrainer.pad_pairs(x, y, 5, n_folds=4, seed=0)
    want = rtrainer.family_cv_grid(ref, "rbf", GAMMAS, CS, 15,
                                   use_pallas=False)
    got = ttrainer.family_cv_grid_size_sharded(port, "rbf", GAMMAS, CS, 15,
                                               devices=["cpu"] * 8)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert len(ttrainer.shard_lane_layout(port.n_true, 8)) <= 8


# -- the Gram-memory gate -----------------------------------------------------------


class _Shaped:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("shape,g,gated", [
    ((10, 200, 5), 7, False), ((3, 399, 4), 7, False),
    ((66, 1582, 5), 7, True), ((66, 1582, 5), 1, False)])
def test_seq_gamma_gate(shape, g, gated):
    """Off at UCI shapes, on at the har12 scale-out (66 x 7 Grams of
    1582^2: ~4.6 GB), as the reference decides; one gamma's Grams (660 MB)
    stay under the gate."""
    args = (_Shaped(shape), _Shaped((g,)))
    assert ttrainer._seq_gamma(*args) is gated
    assert rtrainer._seq_gamma(*args) == gated
    assert ttrainer.CV_GRID_VMAP_BYTES == rtrainer.CV_GRID_VMAP_BYTES


def test_gated_hw_grid_equals_stacked(monkeypatch):
    """With the gate forced (``CV_GRID_VMAP_BYTES = 0``) the hw family's CV
    grid runs one Gram-input solve per gamma and gives the stacked grid;
    string kinds never take the gate."""
    _, port = _both_padded()
    hw = ttrainer.default_hw(0)
    g = ttrainer.hw_gamma_grid(hw, 3)
    calls = []
    solve = kops.solve_lanes_gram

    def counted(kp, *a, **kw):
        calls.append(kp.shape[1])
        return solve(kp, *a, **kw)

    monkeypatch.setattr(kops, "solve_lanes_gram", counted)
    stacked = ttrainer.family_cv_grid(port, hw.kernel_response, g, CS, 15,
                                      device="cpu")
    assert calls == [3]
    monkeypatch.setattr(ttrainer, "CV_GRID_VMAP_BYTES", 0)
    calls.clear()
    gated = ttrainer.family_cv_grid(port, hw.kernel_response, g, CS, 15,
                                    device="cpu")
    assert calls == [1, 1, 1]
    np.testing.assert_array_equal(gated, stacked)
    calls.clear()
    ttrainer.family_cv_grid(port, "rbf", GAMMAS, CS, 5, device="cpu")
    assert calls == []


# -- sequential Algorithm 1 and the deprecated shim --------------------------------


def _balance_subsample(n=150, seed=0):
    ds = tds.load("balance")
    idx = np.random.RandomState(seed).permutation(len(ds.y_train))[:n]
    return ds.x_train[idx], ds.y_train[idx]


@pytest.fixture(scope="module")
def balance_pairs():
    x, y = _balance_subsample()
    hw = ttrainer.default_hw(0)
    seq = tselection.train_pairs_sequential(x, y, 3, hw=hw, n_epochs=60,
                                            seed=0, device="cpu")
    bat = ttrainer.train_pairs(x, y, 3, hw=hw, n_epochs=60, seed=0,
                               device="cpu")
    return seq, bat


def test_sequential_matches_engine_selection(balance_pairs):
    """Same kernel map, same (gamma, C) picks and support sets, CV
    accuracies within the comparator-tie tolerance."""
    seq, bat = balance_pairs
    assert [p.kernel for p in seq] == [p.kernel for p in bat]
    assert "rbf" in [p.kernel for p in seq]
    for ps, pb in zip(seq, bat):
        assert ps.pair == pb.pair
        assert abs(ps.acc_linear - pb.acc_linear) < 1e-3
        assert abs(ps.acc_rbf - pb.acc_rbf) < 1e-3
        assert (ps.model_hw is None) == (pb.model_hw is None)
        for slot in ("model_linear", "model_rbf", "model_hw"):
            ms, mb = getattr(ps, slot), getattr(pb, slot)
            if ms is None:
                continue
            assert (ms.gamma, ms.c) == (mb.gamma, mb.c), (ps.pair, slot)
            assert ms.n_support == mb.n_support, (ps.pair, slot)
            # hw is looser: the engine trains with the uniform-grid fast
            # interpolation, the sequential path with the behavioral model.
            tol = dict(atol=5e-3, rtol=5e-3) if slot == "model_hw" \
                else dict(atol=5e-4, rtol=1e-3)
            np.testing.assert_allclose(mb.alpha, ms.alpha, **tol)


def test_explore_warns_and_matches_build_banks():
    x, y = _balance_subsample(90)
    hw = ttrainer.default_hw(0)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        res = tselection.explore(x, y, 3, hw=hw, n_epochs=20, seed=0,
                                 device="cpu")
    assert isinstance(res, tselection.ExplorationResult)
    pairs = tselection.train_pairs(x, y, 3, hw=hw, n_epochs=20, seed=0,
                                   device="cpu")
    assert res.kernel_map == [p.kernel for p in pairs]
    assert res.n_rbf == sum(k == "rbf" for k in res.kernel_map)
    banks = tselection.build_banks(pairs, 3, hw=hw)
    for field, target in (("mixed_float", "float"),
                          ("linear_float", "linear_float"),
                          ("rbf_float", "rbf_float"),
                          ("mixed_circuit", "circuit"),
                          ("linear_circuit", "linear"),
                          ("rbf_circuit", "rbf")):
        np.testing.assert_array_equal(
            getattr(res, field).predict(x, device="cpu"),
            banks[target].predict(x, device="cpu"))


# -- the same functions in the reference, on the same inputs ----------------------


def _assert_same_pairs(port, ref):
    """Same kernel map and, per pair and family, the same (gamma, C) and
    support set, with alphas within solver tolerance (hw 5e-3)."""
    assert [p.kernel for p in port] == [p.kernel for p in ref]
    for pt, pr in zip(port, ref):
        assert pt.pair == pr.pair
        np.testing.assert_allclose([pt.acc_linear, pt.acc_rbf],
                                   [pr.acc_linear, pr.acc_rbf], atol=1e-6)
        assert (pt.model_hw is None) == (pr.model_hw is None)
        for slot in ("model_linear", "model_rbf", "model_hw"):
            mt, mr = getattr(pt, slot), getattr(pr, slot)
            if mr is None:
                continue
            assert mt.c == mr.c, (pr.pair, slot)
            # the hw grid derives from the calibrated gamma0, equal to f32
            np.testing.assert_allclose(mt.gamma, mr.gamma, rtol=1e-7)
            np.testing.assert_array_equal(mt.support_x, mr.support_x)
            tol = dict(atol=5e-3, rtol=5e-3) if slot == "model_hw" \
                else dict(atol=5e-4, rtol=1e-3)
            np.testing.assert_allclose(mt.alpha, mr.alpha, **tol)


def test_sequential_matches_reference_sequential():
    """The port's sequential Algorithm 1 against the reference's on the
    150-row Balance subsample, with the reference's behavioral model."""
    from repro.core import selection as rselection

    x, y = _balance_subsample()
    ref_hw = rtrainer.default_hw(0)
    ref = rselection.train_pairs_sequential(x, y, 3, hw=ref_hw, n_epochs=60,
                                            seed=0)
    port = tselection.train_pairs_sequential(
        x, y, 3, hw=_port_hw_of(ref_hw), n_epochs=60, seed=0, device="cpu")
    assert "rbf" in [p.kernel for p in ref]
    _assert_same_pairs(port, ref)


def test_explore_matches_reference_explore():
    """The deprecated shim against the reference's: both warn, and give the
    same pairs, kernel map and design points (accuracy of each)."""
    from repro.core import selection as rselection

    x, y = _balance_subsample(90)
    ds = tds.load("balance")
    ref_hw = rtrainer.default_hw(0)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        ref = rselection.explore(x, y, 3, hw=ref_hw, n_epochs=20, seed=0)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        port = tselection.explore(x, y, 3, hw=_port_hw_of(ref_hw),
                                  n_epochs=20, seed=0, device="cpu")
    assert port.kernel_map == ref.kernel_map
    assert port.n_rbf == ref.n_rbf
    _assert_same_pairs(port.pairs, ref.pairs)
    for field in ("mixed_float", "linear_float", "rbf_float",
                  "mixed_circuit", "linear_circuit", "rbf_circuit"):
        assert getattr(port, field).accuracy(
            ds.x_test, ds.y_test, device="cpu") == getattr(
                ref, field).accuracy(ds.x_test, ds.y_test), field

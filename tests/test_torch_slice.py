"""The port's first slice as a whole: Algorithm 1 end to end against the
JAX reference.

On the 150-row Balance subsample of tests/test_solver_pallas.py, the
reference (``use_pallas=False``) and the port (``device="cpu"``, the
plain versions of the kernels) fit with the same fabricated core (the
reference's ``jax.random`` draws passed in) and must pick the same kernels,
(gamma, C) and support sets, with alphas within solver tolerance.  Saves
cross in both directions: a reference estimator or machine loaded by the
port reproduces its decision scores (atol 1e-5, rtol 1e-5) and labels
(equal wherever |score| > TIE_EPS, DESIGN.md §1.4), accuracies and Table II
costs — including the hand-built machines of
tests/test_serving_svm.py::tiny_machine.
"""
import jax
import numpy as np
import pytest

from repro.api import MixedKernelSVM as RefSVM
from repro.api import compile_machine as ref_compile_machine
from repro.core import hwcost as rhw
from repro.data import datasets as rds
from repro_torch.api import CompiledMachine, MixedKernelSVM
from repro_torch.api import compiled as tcompiled
from repro_torch.api import estimator as testimator
from repro_torch.core import analog as tanalog
from repro_torch.core import hwcost as thw
from test_serving_svm import tiny_machine

TIE_EPS = 1e-5
FIT = dict(n_epochs=40, cv_epochs=20, seed=0)


def _reference_offsets(seed=0):
    kg, ka = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.normal(kg, (4,))),
            np.asarray(jax.random.normal(ka, (2,))))


def _balance_subsample(n=150, seed=0):
    ds = rds.load("balance")
    idx = np.random.RandomState(seed).permutation(len(ds.y_train))[:n]
    return ds.x_train[idx], ds.y_train[idx], ds


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    x, y, ds = _balance_subsample()
    ref = RefSVM(use_pallas=False, **FIT).fit(x, y)
    port = MixedKernelSVM(device="cpu", hw_offsets=_reference_offsets(),
                          **FIT).fit(x, y)
    path = str(tmp_path_factory.mktemp("est") / "balance")
    ref.save(path)
    return ref, port, path, ds


def _port_hw_of(ref_hw):
    """The port's behavioral model with the reference model's fields."""
    return tanalog.AnalogRBFModel(
        tanalog.CircuitParams(), ref_hw.dv_grid, ref_hw.kernel_curve,
        ref_hw.a0, ref_hw.gamma0, ref_hw.mu, ref_hw.alpha_x0, ref_hw.alpha_s,
        ref_hw.dva_grid, ref_hw.alpha_curve, ref_hw.v_scale)


#: Measured-curve (analog 'hw') columns: a kernel value is an f32
#: interpolation on a steep curve, and a 1-ulp move of ``dv`` moves it by up
#: to ~1e-6; the score sums it against the column's coefficients.  The
#: reference itself moves such a column by 3.2e-5 between jit and eager
#: evaluation at a coefficient mass of 320 (ROADMAP queue C.5), so those
#: columns get an extra ``HW_KERNEL_ULP * sum|coef|`` on top of atol 1e-5.
HW_KERNEL_ULP = 2e-7


def _hw_coef_mass(ref_machine) -> np.ndarray:
    mass = np.zeros(ref_machine.n_pairs)
    for bank in ref_machine._kernel_banks:
        if bank.kind == "hw":
            mass[np.asarray(bank.pair_idx)] = (
                np.abs(np.asarray(bank.coef_pos)).sum(1)
                + np.abs(np.asarray(bank.coef_neg)).sum(1))
    return mass


def _assert_scores(got, want, hw_mass=0.0):
    atol = 1e-5 + HW_KERNEL_ULP * np.asarray(hw_mass)
    bad = np.abs(got - want) > atol + 1e-5 * np.abs(want)
    assert not bad.any(), (np.abs(got - want).max(), np.argwhere(bad)[:5])


def _assert_labels_off_ties(bits_got, bits_want, scores):
    clear = np.abs(scores) > TIE_EPS
    np.testing.assert_array_equal(bits_got[clear], bits_want[clear])


# -- training parity -----------------------------------------------------------


def test_fit_same_kernel_map(fitted):
    ref, port, _, _ = fitted
    assert port.kernel_map_ == ref.kernel_map_


def test_fit_same_hyperparameters_and_support_sets(fitted):
    ref, port, _, _ = fitted
    for pr, pt in zip(ref.pairs_, port.pairs_):
        assert pt.pair == pr.pair
        np.testing.assert_allclose([pt.acc_linear, pt.acc_rbf],
                                   [pr.acc_linear, pr.acc_rbf], atol=1e-6)
        for slot in ("model_linear", "model_rbf", "model_hw"):
            mr, mt = getattr(pr, slot), getattr(pt, slot)
            assert mt.kind == mr.kind and mt.c == mr.c
            # linear/rbf grids are fixed; the hw grid derives from the
            # calibrated gamma0, equal to f32
            np.testing.assert_allclose(mt.gamma, mr.gamma, rtol=1e-7)
            np.testing.assert_array_equal(mt.support_x, mr.support_x)
            np.testing.assert_array_equal(mt.support_y, mr.support_y)
            np.testing.assert_allclose(mt.alpha, mr.alpha, atol=5e-4,
                                       rtol=1e-3)
            np.testing.assert_allclose(mt.bias, mr.bias, atol=5e-3)
            if mr.w is not None:
                np.testing.assert_allclose(mt.w, mr.w, atol=5e-3)


def test_fit_same_accuracy_and_cost(fitted):
    ref, port, _, ds = fitted
    for target in ref.targets:
        assert port.score(ds.x_test, ds.y_test, target) == \
            ref.score(ds.x_test, ds.y_test, target), target
    for target in ("linear", "circuit", "rbf"):
        cr = rhw.system_cost(ref.bank(target), rhw.CostModel())
        ct = thw.system_cost(port.bank(target), thw.CostModel())
        np.testing.assert_allclose([ct.area_mm2, ct.power_mw],
                                   [cr.area_mm2, cr.power_mw], rtol=1e-12)


# -- saves across packages ------------------------------------------------------


@pytest.mark.parametrize("target", ["float", "circuit", "linear", "rbf",
                                    "linear_float", "rbf_float"])
def test_reference_estimator_loads_with_same_scores(fitted, target):
    """The reference's save, loaded around the reference's calibrated core:
    every target's decision scores and labels, accuracy and cost."""
    ref, _, path, ds = fitted
    port = MixedKernelSVM.load(path, device="cpu", hw=_port_hw_of(ref.hw_))
    assert port.kernel_map_ == ref.kernel_map_
    x = ds.x_test
    want = ref.deploy(target).decision_scores(x)
    _assert_scores(port.deploy(target).decision_scores(x), want,
                   _hw_coef_mass(ref.deploy(target)))
    _assert_labels_off_ties(port.predict_bits(x, target),
                            ref.predict_bits(x, target), want)
    assert port.score(x, ds.y_test, target) == \
        ref.score(x, ds.y_test, target)
    if target in ("linear", "circuit", "rbf"):
        cr = rhw.system_cost(ref.bank(target), rhw.CostModel())
        ct = thw.system_cost(port.bank(target), thw.CostModel())
        assert ct.__dict__ == cr.__dict__


def test_reference_estimator_loads_recalibrated(fitted):
    """Loaded with only the core's draws, the port recalibrates the analog
    model itself (f32-equal curves): same labels off ties everywhere."""
    ref, _, path, ds = fitted
    port = MixedKernelSVM.load(path, device="cpu",
                               hw_offsets=_reference_offsets())
    x = ds.x_test
    for target in ref.targets:
        _assert_labels_off_ties(port.predict_bits(x, target),
                                ref.predict_bits(x, target),
                                ref.deploy(target).decision_scores(x))


def test_port_estimator_save_loads_in_reference(fitted, tmp_path):
    _, port, _, ds = fitted
    port_hw = port.hw_
    path = str(tmp_path / "port")
    # a port estimator around the reference core's draws is serializable
    port.save(path)
    ref = RefSVM.load(path, use_pallas=False)
    again = MixedKernelSVM.load(path, device="cpu",
                                hw_offsets=_reference_offsets())
    x = ds.x_test
    for target in port.targets:
        want = port.deploy(target).decision_scores(x)
        np.testing.assert_array_equal(
            again.deploy(target).decision_scores(x), want)
        _assert_labels_off_ties(ref.predict_bits(x, target),
                                port.predict_bits(x, target), want)
    assert port_hw.mu == again.hw_.mu


def test_estimator_from_arrays_plain_function(fitted):
    ref, _, path, ds = fitted
    import json
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path + ".npz") as npz:
        arrays = {k: npz[k] for k in npz.files}
    port = testimator.estimator_from_arrays(meta, arrays, device="cpu",
                                            hw=_port_hw_of(ref.hw_))
    _assert_scores(port.deploy("rbf").decision_scores(ds.x_test),
                   ref.deploy("rbf").decision_scores(ds.x_test))


@pytest.mark.parametrize("target", ["float", "circuit", "rbf"])
def test_reference_machine_loads_with_same_scores(fitted, tmp_path, target):
    ref, _, _, ds = fitted
    path = str(tmp_path / target)
    ref.deploy(target).save(path)
    port = CompiledMachine.load(path, device="cpu")
    want = ref.deploy(target).decision_scores(ds.x_test)
    _assert_scores(port.decision_scores(ds.x_test), want,
                   _hw_coef_mass(ref.deploy(target)))
    _assert_labels_off_ties(port.predict_bits(ds.x_test),
                            ref.deploy(target).predict_bits(ds.x_test), want)
    np.testing.assert_array_equal(port.predict(ds.x_test),
                                  ref.deploy(target).predict(ds.x_test))


@pytest.mark.parametrize("name,kw", [
    ("tiny", dict(seed=0, d=3, m=6, n_classes=3)),
    ("wide", dict(seed=1, d=5, m=8, n_classes=4)),
    ("analog", dict(seed=2, d=4, m=6, n_classes=3, analog_pairs=(1,))),
    ("votes", dict(seed=3, d=2, m=4, n_classes=6)),   # P = 15 > 12 bits
])
def test_reference_tiny_machines_load(tmp_path, name, kw):
    """The hand-built machines of the reference's serving tests."""
    machine = tiny_machine(**kw)
    path = str(tmp_path / name)
    machine.save(path)
    port = CompiledMachine.load(path, device="cpu")
    x = np.random.default_rng(7).normal(size=(33, machine.n_features)
                                        ).astype(np.float32)
    want = machine.decision_scores(x)
    _assert_scores(port.decision_scores(x), want, _hw_coef_mass(machine))
    _assert_labels_off_ties(port.predict_bits(x), machine.predict_bits(x),
                            want)
    np.testing.assert_array_equal(port.predict(x), machine.predict(x))
    # and back: the port's save is the reference's format
    port.save(str(tmp_path / "back"))
    again = type(machine).load(str(tmp_path / "back"))
    np.testing.assert_array_equal(again.decision_scores(x), want)


def test_compile_machine_matches_reference_lowering():
    """The same classifier objects built in both packages (linear, digital
    RBF, analog and float pairs) lower to machines with equal scores."""
    from repro.core import analog as ranalog
    from repro.core import ovo as rovo
    from repro.core import svm as rsvm
    from repro.core import trainer as rtrainer
    from repro_torch.core import ovo as tovo
    from repro_torch.core import svm as tsvm

    ref_hw = rtrainer.default_hw(0)
    built = {}
    for tag, svm, ovo, analog, hw in (
            ("ref", rsvm, rovo, ranalog, ref_hw),
            ("port", tsvm, tovo, tanalog, _port_hw_of(ref_hw))):
        gen = np.random.default_rng(5)
        clfs = []
        for p in range(6):                           # K = 4
            m, d = 7, 3
            sx = gen.normal(size=(m, d))
            sy = np.where(np.arange(m) % 2 == 0, 1.0, -1.0)
            alpha = np.abs(gen.normal(size=m)) + 0.1
            kind = "linear" if p % 3 == 0 else "rbf"
            model = svm.SVMModel(kind=kind, support_x=sx, support_y=sy,
                                 alpha=alpha, bias=0.1 * p, gamma=0.7, c=1.0,
                                 w=(alpha * sy) @ sx if kind == "linear"
                                 else None)
            clfs.append([
                lambda: ovo.DigitalLinearClassifier.deploy(model),
                lambda: ovo.DigitalRBFClassifier.deploy(model),
                lambda: analog.AnalogBinaryClassifier.deploy(model, hw),
                lambda: ovo.FloatBitClassifier(model),
                lambda: model,
                lambda: ovo.FloatBitClassifier(model),
            ][p]())
        built[tag] = clfs
    want_m = ref_compile_machine(built["ref"], n_classes=4)
    got_m = tcompiled.compile_machine(built["port"], n_classes=4,
                                      device="cpu")
    x = np.random.default_rng(1).uniform(size=(40, 3))
    want = want_m.decision_scores(x)
    _assert_scores(got_m.decision_scores(x), want, _hw_coef_mass(want_m))
    _assert_labels_off_ties(got_m.predict_bits(x), want_m.predict_bits(x),
                            want)

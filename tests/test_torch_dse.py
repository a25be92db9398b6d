"""The port's kernel-assignment design space against the JAX reference.

The reference fits the 150-row Balance subsample (as
tests/test_torch_slice.py) and saves it; the port loads that save around
the reference's calibrated core, so both packages hold the same candidates.
Then, on the CPU (``device="cpu"``):

* ``pair_cost_table`` / ``assignment_costs`` equal ``system_cost`` on the
  object banks and the reference's table (rtol 1e-6);
* the candidate bits equal the reference's wherever |score| > TIE_EPS;
* the exhaustive sweep's accuracies equal the reference's bit for bit and
  the fronts are the same sets of assignments; the recombination of the
  same bits is bit for bit the reference's (an exact integer count times
  the f32 reciprocal of n), votes fallback included, with the lowest-index
  argmax tiebreak and a front with an exact accuracy tie;
* the portfolio search at K = 5 (``max_exhaustive=0``) visits the same
  assignments with the same accuracies (synthetic candidates of
  tests/test_dse.py:241, built in both packages from one numpy seed);
* ``select`` under area, power and yield budgets picks the reference's
  point; budgeted deploys round-trip through saves in both directions.
"""
import jax
import numpy as np
import pytest
import torch

from repro.api import MixedKernelSVM as RefSVM
from repro.core import dse as rdse
from repro.core import hwcost as rhw
from repro.core import ovo as rovo
from repro.core import trainer as rtrainer
from repro.core.analog import AnalogBinaryClassifier as RefAnalog
from repro.core.svm import SVMModel as RefModel
from repro.data import datasets as rds
from repro_torch.api import MixedKernelSVM
from repro_torch.core import analog as tanalog
from repro_torch.core import dse as tdse
from repro_torch.core import hwcost as thw
from repro_torch.core import ovo as tovo
from repro_torch.core import svm as tsvm

TIE_EPS = 1e-5
FIT = dict(n_epochs=40, cv_epochs=20, seed=0)


def _reference_offsets(seed=0):
    kg, ka = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.normal(kg, (4,))),
            np.asarray(jax.random.normal(ka, (2,))))


def _port_hw_of(ref_hw):
    """The port's behavioral model with the reference model's fields."""
    return tanalog.AnalogRBFModel(
        tanalog.CircuitParams(), ref_hw.dv_grid, ref_hw.kernel_curve,
        ref_hw.a0, ref_hw.gamma0, ref_hw.mu, ref_hw.alpha_x0, ref_hw.alpha_s,
        ref_hw.dva_grid, ref_hw.alpha_curve, ref_hw.v_scale)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    ds = rds.load("balance")
    idx = np.random.RandomState(0).permutation(len(ds.y_train))[:150]
    ref = RefSVM(use_pallas=False, **FIT).fit(ds.x_train[idx],
                                              ds.y_train[idx])
    path = str(tmp_path_factory.mktemp("est") / "balance")
    ref.save(path)
    port = MixedKernelSVM.load(path, device="cpu", hw=_port_hw_of(ref.hw_))
    return ref, port, path, ds


@pytest.fixture(scope="module")
def sweeps(fitted):
    ref, port, _, ds = fitted
    return (ref.pareto(ds.x_test, ds.y_test),
            port.pareto(ds.x_test, ds.y_test))


def _banks(est, ovo):
    cands = est._candidates()
    kmap = est.kernel_map_
    p = len(kmap)

    def bank(kernels):
        clfs = [c[1] if k == "rbf" else c[0] for c, k in zip(cands, kernels)]
        return ovo.MulticlassSVM(n_classes=est.n_classes_, classifiers=clfs,
                                 kernel_map=list(kernels))

    return {"all_linear": (np.zeros(p, bool), bank(["linear"] * p)),
            "all_rbf": (np.ones(p, bool), bank(["rbf"] * p)),
            "alg1": (tdse.assignment_from_kernel_map(kmap), bank(kmap))}


# -- cost layer -------------------------------------------------------------------


def test_assignment_costs_match_system_cost_and_reference(fitted):
    ref, port, _, _ = fitted
    cm = thw.CostModel()
    table = port.design_space(cm).cost_table
    ref_table = ref.design_space(rhw.CostModel()).cost_table
    for field in ("area", "power", "n_features", "encoder_area",
                  "encoder_power", "adc_area_per_feature",
                  "adc_power_per_feature"):
        np.testing.assert_allclose(getattr(table, field),
                                   getattr(ref_table, field), rtol=1e-6)
    for name, (a, bank) in _banks(port, tovo).items():
        want = thw.system_cost(bank, cm)
        area, power = thw.assignment_costs(table, a[None, :])
        np.testing.assert_allclose([area[0], power[0]],
                                   [want.area_mm2, want.power_mw],
                                   rtol=1e-6, err_msg=name)
    every = tdse.enumerate_assignments(table.n_pairs)
    np.testing.assert_allclose(thw.assignment_costs(table, every),
                               rhw.assignment_costs(ref_table, every),
                               rtol=1e-6)


def test_assignment_costs_from_raw_candidates(fitted):
    _, port, _, _ = fitted
    cm = thw.CostModel()
    cands = port._candidates()
    a = tdse.enumerate_assignments(len(cands))
    ar1, pw1 = thw.assignment_costs(cands, a, cm)
    ar2, pw2 = thw.assignment_costs(thw.pair_cost_table(cands, cm), a)
    np.testing.assert_array_equal(ar1, ar2)
    np.testing.assert_array_equal(pw1, pw2)
    with pytest.raises(ValueError, match="CostModel"):
        thw.assignment_costs(cands, a)


# -- the candidate bit tensor ----------------------------------------------------


def test_pair_bits_match_reference_and_object_banks(fitted):
    ref, port, _, ds = fitted
    machine = port.design_space().machine
    ref_machine = ref.design_space().machine
    banks = _banks(port, tovo)
    for x in (ds.x_train, ds.x_test):
        bits = machine.pair_bits(x)
        assert bits.shape == (len(x), 3, 2) and bits.dtype == np.int32
        scores = ref_machine.pair_scores(x)
        clear = np.abs(scores) > TIE_EPS
        np.testing.assert_array_equal(bits[clear],
                                      ref_machine.pair_bits(x)[clear])
        np.testing.assert_array_equal(
            bits[:, :, 0], banks["all_linear"][1].predict_bits(x, "cpu"))
        np.testing.assert_array_equal(
            bits[:, :, 1], banks["all_rbf"][1].predict_bits(x, "cpu"))


# -- the exhaustive sweep ----------------------------------------------------------


def test_exhaustive_sweep_matches_reference(sweeps):
    ref_sw, sw = sweeps
    assert sw.exhaustive and sw.assignments.shape == (8, 3)
    np.testing.assert_array_equal(sw.assignments, ref_sw.assignments)
    np.testing.assert_array_equal(sw.accuracy, ref_sw.accuracy)
    np.testing.assert_allclose(sw.area, ref_sw.area, rtol=1e-6)
    np.testing.assert_allclose(sw.power, ref_sw.power, rtol=1e-6)
    assert {sw.assignments[i].tobytes() for i in sw.front} == \
        {ref_sw.assignments[i].tobytes() for i in ref_sw.front}


def test_sweep_accuracies_equal_compiled_machines(fitted, sweeps):
    _, port, _, ds = fitted
    _, sw = sweeps
    for s in range(sw.assignments.shape[0]):
        machine = port.deploy_assignment(sw.kernel_map(s))
        assert sw.accuracy[s] == pytest.approx(
            machine.accuracy(ds.x_test, ds.y_test), abs=1e-6), s


def test_alg1_vertex_and_domination(fitted, sweeps):
    ref, port, _, ds = fitted
    ref_sw, sw = sweeps
    alg1 = tdse.assignment_from_kernel_map(port.kernel_map_)
    i = sw.find(alg1)
    assert i is not None
    assert sw.accuracy[i] == pytest.approx(
        port.score(ds.x_test, ds.y_test, target="circuit"), abs=1e-6)
    assert sw.domination_margin(alg1) == ref_sw.domination_margin(alg1)
    assert sw.front_points() == ref_sw.front_points()


def test_recombination_of_the_same_bits_is_bit_for_bit(fitted):
    """The reference's own bits through the port's recombination: every
    accuracy equal, through the encoder table and the votes fallback."""
    ref, _, _, ds = fitted
    bits = ref.design_space().machine.pair_bits(ds.x_test)
    a = rdse.enumerate_assignments(3)
    want = rdse.assignment_accuracies(bits, a, ds.y_test, 3)
    enc = tdse.assignment_accuracies(bits, a, ds.y_test, 3, device="cpu")
    votes = tdse.assignment_accuracies(bits, a, ds.y_test, 3,
                                       max_table_bits=0, device="cpu")
    np.testing.assert_array_equal(enc, want)
    np.testing.assert_array_equal(votes, enc)
    np.testing.assert_array_equal(
        votes, rdse.assignment_accuracies(bits, a, ds.y_test, 3,
                                          max_table_bits=0))


@pytest.mark.parametrize("n,k", [(188, 3), (400, 5), (63, 4)])
def test_accuracy_rounding_is_the_references(n, k):
    """Every count 0..n on random bits: the f32 accuracy of the port
    equals the reference's (count times the f32 reciprocal of n)."""
    rng = np.random.RandomState(n)
    p = k * (k - 1) // 2
    bits = rng.randint(0, 2, (n, p, 2)).astype(np.int32)
    a = rng.rand(40, p) < 0.5
    table = rovo.build_encoder_table(k)
    for s in range(3):
        # Labels chosen so assignment s scores every count once.
        lab = table[(bits[:, :, 1] * a[s] + bits[:, :, 0] * ~a[s])
                    @ (1 << np.arange(p))]
        y = np.where(np.arange(n) < rng.randint(0, n + 1), lab,
                     (lab + 1) % k)
        np.testing.assert_array_equal(
            tdse.assignment_accuracies(bits, a, y, k, device="cpu"),
            rdse.assignment_accuracies(bits, a, y, k))


def test_votes_argmax_tie_is_lowest_index():
    """A 3-cycle of pair bits gives every class one vote: the label is
    class 0, as ``ovo.decide_votes`` breaks the tie."""
    cyc = np.array([[1, 0, 1]], np.int32)     # 0>1, 2>0, 1>2
    bits = np.stack([cyc, 0 * cyc], axis=-1).repeat(4, axis=0)
    y = np.array([0, 1, 2, 0])
    a = np.array([[0, 0, 0], [1, 1, 1]], bool)
    assert rovo.decide_votes(cyc, 3).tolist() == [0]
    got = tdse.assignment_accuracies(bits, a, y, 3, max_table_bits=0,
                                     device="cpu")
    np.testing.assert_array_equal(got, [0.5, 0.25])   # all-zero bits: 2
    np.testing.assert_array_equal(
        got, rdse.assignment_accuracies(bits, a, y, 3, max_table_bits=0))


def test_front_with_an_exact_accuracy_tie():
    """Two points with the same accuracy: the costlier one is dominated,
    an equal-cost copy is not; the port's front and selection are the
    reference's."""
    acc = np.float64(np.float32(np.array([0.75, 0.75, 0.75, 0.8, 0.6])))
    area = np.array([1.0, 2.0, 1.0, 3.0, 0.5])
    power = np.array([1.0, 1.0, 1.0, 2.0, 0.5])
    got = tdse.pareto_front(acc, area, power)
    np.testing.assert_array_equal(got, rdse.pareto_front(acc, area, power))
    assert sorted(got.tolist()) == [0, 2, 3, 4]
    yld = np.array([0.5, 0.9, 0.5, 0.1, 1.0])
    np.testing.assert_array_equal(
        tdse.pareto_front(acc, area, power, yield_=yld),
        rdse.pareto_front(acc, area, power, yield_=yld))


@pytest.mark.parametrize("seed", range(4))
def test_pareto_front_matches_reference_on_random_ties(seed):
    """The port reduces the front in lexicographic blocks (O(S x front))
    where the reference compares all pairs: the same indices, in the same
    order, on coarse random objectives full of ties, in both modes."""
    rng = np.random.RandomState(seed)
    s = 1 + rng.randint(3000)
    acc = np.round(rng.rand(s) * 20) / 20
    area, power = np.round(rng.rand(s) * 10), np.round(rng.rand(s) * 10)
    yld = np.round(rng.rand(s) * 4) / 4
    np.testing.assert_array_equal(tdse.pareto_front(acc, area, power),
                                  rdse.pareto_front(acc, area, power))
    np.testing.assert_array_equal(
        tdse.pareto_front(acc, area, power, yield_=yld),
        rdse.pareto_front(acc, area, power, yield_=yld))


# -- selection -------------------------------------------------------------------


def _port_result(ref_sw):
    fields = {f: getattr(ref_sw, f) for f in (
        "assignments", "accuracy", "area", "power", "front", "n_classes",
        "exhaustive", "elapsed_s", "assignments_per_s")}
    return tdse.SweepResult(**fields)


def test_select_under_budgets_matches_reference(sweeps):
    ref_sw, sw = sweeps
    for j in ref_sw.front:
        for kw in (dict(area_budget=float(ref_sw.area[j])),
                   dict(power_budget=float(ref_sw.power[j])),
                   dict(area_budget=float(ref_sw.area[j]),
                        power_budget=float(ref_sw.power[j]))):
            assert sw.select(**kw) == ref_sw.select(**kw), kw
            assert _port_result(ref_sw).select(**kw) == ref_sw.select(**kw)
    with pytest.raises(ValueError, match="budget"):
        sw.select(area_budget=1e-9)
    with pytest.raises(RuntimeError, match="Monte-Carlo"):
        sw.select(yield_floor=0.9)


def test_select_under_yield_floor_matches_reference():
    """The robust rule on one set of per-variant accuracies, with and
    without the Wilson gate."""
    rng = np.random.RandomState(3)
    s, v = 16, 64
    a = rdse.enumerate_assignments(4)
    acc_mc = np.clip(0.8 + 0.05 * rng.randn(v, s) * a.sum(1) / 4, 0, 1)
    area = 1.0 + a.sum(1) + 0.01 * rng.rand(s)
    power = 0.5 + a.sum(1) * 0.3
    common = dict(assignments=a, accuracy=acc_mc[0], area=area, power=power,
                  front=rdse.pareto_front(acc_mc[0], area, power),
                  n_classes=4, exhaustive=True, elapsed_s=0.0,
                  assignments_per_s=0.0)
    results = []
    for mod in (rdse, tdse):
        stats = mod.mc_statistics(acc_mc, 0.78)
        r = mod.SweepResult(**common)
        r.accuracy_mc = acc_mc
        r.acc_mean, r.acc_std = stats["mean"], stats["std"]
        r.acc_worst, r.yield_ = stats["worst"], stats["yield"]
        r.accuracy_floor, r.n_variants = 0.78, v
        r.robust_front = mod.pareto_front(r.acc_mean, area, power,
                                          yield_=r.yield_)
        results.append(r)
    ref_r, port_r = results
    np.testing.assert_array_equal(port_r.robust_front, ref_r.robust_front)
    for floor in (0.2, 0.5, 0.8):
        for kw in (dict(), dict(confidence=0.95),
                   dict(area_budget=float(np.median(area)))):
            try:
                want = ref_r.select(yield_floor=floor, **kw)
            except ValueError:
                with pytest.raises(ValueError, match="yield"):
                    port_r.select(yield_floor=floor, **kw)
                continue
            assert port_r.select(yield_floor=floor, **kw) == want


# -- synthetic spaces (K = 5) -------------------------------------------------------


def _synthetic_candidates(pkg, n_classes, d, m, seed=0):
    """tests/test_dse.py::_synthetic_candidates in either package, both
    around the reference's calibrated core."""
    ref_hw = rtrainer.default_hw(0)
    gamma = float(rtrainer.hw_gamma_grid(ref_hw)[3])
    if pkg == "ref":
        model, ovo, analog, hw = RefModel, rovo, RefAnalog, ref_hw
    else:
        model, ovo, analog, hw = (tsvm.SVMModel, tovo,
                                  tanalog.AnalogBinaryClassifier,
                                  _port_hw_of(ref_hw))
    rng = np.random.RandomState(seed)
    cands = []
    for _ in rovo.class_pairs(n_classes):
        w = rng.randn(d)
        lin = model(kind="linear", support_x=np.zeros((1, d)),
                    support_y=np.ones(1), alpha=np.zeros(1),
                    bias=float(-w.sum() / 2), gamma=1.0, c=1.0, w=w)
        sv = rng.rand(m, d)
        yv = np.where(rng.rand(m) > 0.5, 1.0, -1.0)
        rbf = model(kind="hw", support_x=sv, support_y=yv,
                    alpha=rng.rand(m) + 0.1, bias=float(rng.randn() * 0.1),
                    gamma=gamma, c=1.0, kernel_fn=hw.kernel_response)
        cands.append((ovo.DigitalLinearClassifier.deploy(lin),
                      analog.deploy(rbf, hw)))
    return cands


@pytest.fixture(scope="module")
def k5():
    rng = np.random.RandomState(1)
    x = rng.rand(400, 4).astype(np.float32)
    y = rng.randint(0, 5, 400)
    ref = rdse.DesignSpace.from_candidates(
        _synthetic_candidates("ref", 5, 4, 6), 5, rhw.CostModel())
    port = tdse.DesignSpace.from_candidates(
        _synthetic_candidates("port", 5, 4, 6), 5, thw.CostModel(),
        device="cpu")
    return ref, port, x, y


def test_k5_exhaustive_matches_reference(k5):
    ref, port, x, y = k5
    bits = port.machine.pair_bits(x)
    clear = np.abs(ref.machine.pair_scores(x)) > TIE_EPS
    np.testing.assert_array_equal(bits[clear], ref.machine.pair_bits(x)[clear])
    sw, ref_sw = port.sweep(x, y), ref.sweep(x, y)
    assert sw.exhaustive and sw.assignments.shape == (1024, 10)
    np.testing.assert_array_equal(sw.accuracy, ref_sw.accuracy)
    np.testing.assert_array_equal(sw.front, ref_sw.front)
    # corners recombine exactly to the single-candidate machines
    table = tovo.build_encoder_table(5)
    for row, col in ((0, 0), (1023, 1)):
        labels = tovo.decide_encoder(bits[:, :, col], table)
        assert sw.accuracy[row] == pytest.approx(np.mean(labels == y),
                                                 abs=1e-6)


def test_k5_portfolio_search_matches_reference(k5):
    ref, port, x, y = k5
    kw = dict(max_exhaustive=0, n_random=4, anneal_steps=32)
    sw, ref_sw = port.sweep(x, y, **kw), ref.sweep(x, y, **kw)
    assert not sw.exhaustive
    np.testing.assert_array_equal(sw.assignments, ref_sw.assignments)
    np.testing.assert_array_equal(sw.accuracy, ref_sw.accuracy)
    np.testing.assert_array_equal(sw.front, ref_sw.front)
    visited = {a.tobytes() for a in sw.assignments}
    ex = port.sweep(x, y)
    assert {ex.assignments[i].tobytes() for i in ex.front if
            ex.assignments[i].tobytes() in visited} <= \
        {sw.assignments[i].tobytes() for i in sw.front}


def test_enumerate_assignments_guard():
    with pytest.raises(ValueError, match="refusing"):
        tdse.enumerate_assignments(13)
    np.testing.assert_array_equal(tdse.enumerate_assignments(4),
                                  rdse.enumerate_assignments(4))


# -- deployment and saves -------------------------------------------------------


def test_deploy_no_budget_is_exact_alg1(fitted, sweeps):
    _, port, _, ds = fitted
    machine = port.deploy("circuit")
    assert machine.kernel_map == port.kernel_map_
    np.testing.assert_array_equal(machine.predict(ds.x_test),
                                  port.bank("circuit").predict(ds.x_test,
                                                               "cpu"))


def test_budgeted_deploy_save_roundtrip(fitted, tmp_path):
    ref, _, path, ds = fitted
    port = MixedKernelSVM.load(path, device="cpu",
                               hw_offsets=_reference_offsets())
    with pytest.raises(RuntimeError, match="pareto"):
        port.deploy("circuit", area_budget=1.0)
    sw = port.pareto(ds.x_test, ds.y_test)
    with pytest.raises(ValueError, match="circuit"):
        port.deploy("linear", area_budget=1.0)
    j = sw.front[len(sw.front) // 2]
    machine = port.deploy("circuit", area_budget=float(sw.area[j]),
                          power_budget=float(sw.power[j]))
    i = sw.find(tdse.assignment_from_kernel_map(port.assignment_))
    assert sw.area[i] <= sw.area[j] and sw.power[i] <= sw.power[j]
    assert machine.accuracy(ds.x_test, ds.y_test) == pytest.approx(
        sw.accuracy[i], abs=1e-6)
    out = str(tmp_path / "port")
    port.save(out)
    again = MixedKernelSVM.load(out, device="cpu",
                                hw_offsets=_reference_offsets())
    assert again.assignment_ == port.assignment_
    np.testing.assert_array_equal(again.deploy_assignment().predict(
        ds.x_test), machine.predict(ds.x_test))
    back = RefSVM.load(out, use_pallas=False)       # the reference reads it
    assert back.assignment_ == port.assignment_


def test_reference_budgeted_save_loads_in_port(fitted, tmp_path):
    ref, _, _, ds = fitted
    sw = ref.pareto(ds.x_test, ds.y_test)
    j = sw.front[0]
    ref.deploy("circuit", area_budget=float(sw.area[j]))
    out = str(tmp_path / "ref")
    ref.save(out)
    want = ref.deploy_assignment()
    ref.assignment_ = None                          # restore fixture state
    port = MixedKernelSVM.load(out, device="cpu", hw=_port_hw_of(ref.hw_))
    assert port.assignment_ == sw.kernel_map(j)
    scores = want.decision_scores(ds.x_test)
    clear = np.abs(scores) > TIE_EPS
    np.testing.assert_array_equal(
        port.deploy_assignment().predict_bits(ds.x_test)[clear],
        want.predict_bits(ds.x_test)[clear])


def test_design_space_runs_where_the_estimator_runs(fitted):
    _, port, _, _ = fitted
    assert port.design_space().device == torch.device("cpu")
    assert port.design_space().machine.device == torch.device("cpu")

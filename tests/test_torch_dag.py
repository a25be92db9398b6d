"""The port's DAG decision front against the JAX reference.

On the CPU (``device="cpu"``), at the shapes of tests/test_dag.py:

* ``decide_dag`` / ``condorcet_mask`` equal the reference's on random bits
  at K in {3, 5, 10, 12}; the DAG equals the votes on Condorcet samples and
  consults exactly K-1 bits;
* machines built in both packages from the SAME trained arrays (the
  reference trains; the port's classifiers take its ``SVMModel`` arrays):
  the step plans equal the reference's ``_dag_step_plans``, the port's DAG
  labels equal the reference's (linear + rbf float banks, and linear +
  analog 'hw' banks around the reference's calibrated core), planned and
  unplanned fronts give the same labels as ``decide_dag`` of the dense bits;
* ``decider="votes"`` is the default and unchanged; decider validation;
* save / load keep the decider, and a reference save written with
  ``"decider": "dag"`` loads in the port and predicts the reference's
  labels;
* the estimator's ``deploy(decider=)`` / ``deploy_assignment(decider=)``
  cache per decider.
"""
import numpy as np
import pytest
import torch

from repro.api import compile_machine as ref_compile
from repro.api.compiled import _dag_step_plans as ref_step_plans
from repro.core import ovo as rovo
from repro.core import svm as rsvm
from repro.core import trainer as rtrainer
from repro.core.analog import AnalogBinaryClassifier as RefAnalog
from repro.core.svm import SVMModel as RefModel
from repro_torch.api import MixedKernelSVM, compile_machine
from repro_torch.api import compiled as tcompiled
from repro_torch.api.compiled import DECIDERS, CompiledMachine
from repro_torch.core import analog as tanalog
from repro_torch.core import ovo as tovo
from repro_torch.core import svm as tsvm

TIE_EPS = 1e-5


# -- host reference: decide_dag / condorcet_mask -------------------------------


@pytest.mark.parametrize("k", [3, 5, 10, 12])
def test_decide_dag_and_condorcet_mask_equal_reference(k):
    rng = np.random.RandomState(k)
    p = len(tovo.class_pairs(k))
    bits = rng.randint(0, 2, size=(500, p))
    ld = tovo.decide_dag(bits, k)
    mask = tovo.condorcet_mask(bits, k)
    np.testing.assert_array_equal(ld, rovo.decide_dag(bits, k))
    np.testing.assert_array_equal(mask, rovo.condorcet_mask(bits, k))
    # The contract: DAG == votes wherever a class won all its pairs.
    assert mask.any()
    np.testing.assert_array_equal(ld[mask], tovo.decide_votes(bits, k)[mask])
    assert ld.min() >= 0 and ld.max() < k


def test_dag_consults_o_k_bits():
    """Flipping every bit outside the consulted path never changes the
    decision."""
    k = 6
    rng = np.random.RandomState(0)
    p = len(tovo.class_pairs(k))
    pm = tovo.pair_index_matrix(k)
    bits = rng.randint(0, 2, size=(64, p))
    for row in bits:
        lo, hi = 0, k - 1
        consulted = []
        for _ in range(k - 1):
            pr = pm[lo, hi]
            consulted.append(pr)
            if row[pr] == 1:
                hi -= 1
            else:
                lo += 1
        flipped = row.copy()
        flipped[np.setdiff1d(np.arange(p), consulted)] ^= 1
        assert tovo.decide_dag(row[None], k)[0] == \
            tovo.decide_dag(flipped[None], k)[0]


# -- machines built in both packages from the reference's trained arrays -------


def _port_model(m: RefModel, kernel_fn=None) -> tsvm.SVMModel:
    return tsvm.SVMModel(
        kind=m.kind, support_x=np.asarray(m.support_x),
        support_y=np.asarray(m.support_y), alpha=np.asarray(m.alpha),
        bias=float(m.bias), gamma=float(m.gamma), c=float(m.c),
        w=None if m.w is None else np.asarray(m.w), kernel_fn=kernel_fn)


def _trained_pairs(k, n=200, seed=0, mixed=True):
    """The reference's trained models of tests/test_dag.py's machines:
    alternating linear / rbf pairs when ``mixed``, all linear otherwise."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3)
    y = rng.randint(0, k, n)
    models = []
    for pi, (ci, cj) in enumerate(rovo.class_pairs(k)):
        mask = (y == ci) | (y == cj)
        yy = np.where(y[mask] == ci, 1.0, -1.0)
        kind = "linear" if (pi % 2 == 0 or not mixed) else "rbf"
        models.append(rsvm.train_binary(x[mask], yy, kind, gamma=2.0, c=1.0,
                                        n_epochs=40, use_pallas=False))
    return models, x, y


def _machines(k, mixed=True, seed=0, **kw):
    """(reference machine, port machine, x) over the same trained arrays."""
    models, x, _ = _trained_pairs(k, seed=seed, mixed=mixed)
    ref = ref_compile([rovo.FloatBitClassifier(m) for m in models],
                      n_classes=k, use_pallas=False, **kw)
    port = compile_machine([tovo.FloatBitClassifier(_port_model(m))
                            for m in models], n_classes=k, device="cpu", **kw)
    return ref, port, x


def _port_hw_of(ref_hw):
    """The port's behavioral model with the reference model's fields."""
    return tanalog.AnalogRBFModel(
        tanalog.CircuitParams(), ref_hw.dv_grid, ref_hw.kernel_curve,
        ref_hw.a0, ref_hw.gamma0, ref_hw.mu, ref_hw.alpha_x0, ref_hw.alpha_s,
        ref_hw.dva_grid, ref_hw.alpha_curve, ref_hw.v_scale)


def _analog_machines(k=5, d=4, m=6, seed=0):
    """Linear digital and analog 'hw' pairs in turn (tests/test_dse.py's
    synthetic candidates), in both packages around the reference's core."""
    ref_hw = rtrainer.default_hw(0)
    port_hw = _port_hw_of(ref_hw)
    gamma = float(rtrainer.hw_gamma_grid(ref_hw)[3])
    rng = np.random.RandomState(seed)
    ref_clfs, port_clfs = [], []
    for pi, _ in enumerate(rovo.class_pairs(k)):
        w = rng.randn(d)
        lin = RefModel(kind="linear", support_x=np.zeros((1, d)),
                       support_y=np.ones(1), alpha=np.zeros(1),
                       bias=float(-w.sum() / 2), gamma=1.0, c=1.0, w=w)
        sv = rng.rand(m - pi % 3, d)
        yv = np.where(rng.rand(len(sv)) > 0.5, 1.0, -1.0)
        rbf = RefModel(kind="hw", support_x=sv, support_y=yv,
                       alpha=rng.rand(len(sv)) + 0.1,
                       bias=float(rng.randn() * 0.1), gamma=gamma, c=1.0,
                       kernel_fn=ref_hw.kernel_response)
        if pi % 2 == 0:
            ref_clfs.append(rovo.DigitalLinearClassifier.deploy(lin))
            port_clfs.append(tovo.DigitalLinearClassifier.deploy(
                _port_model(lin)))
        else:
            ref_clfs.append(RefAnalog.deploy(rbf, ref_hw))
            port_clfs.append(tanalog.AnalogBinaryClassifier.deploy(
                _port_model(rbf, port_hw.kernel_response), port_hw))
    ref = ref_compile(ref_clfs, n_classes=k, use_pallas=False, decider="dag")
    port = compile_machine(port_clfs, n_classes=k, device="cpu",
                           decider="dag")
    x = rng.rand(300, d).astype(np.float32)
    return ref, port, x


def test_step_plans_equal_reference():
    ref, port, _ = _machines(6, decider="dag")
    assert port._kernel_banks, "the mixed machine must have a kernel bank"
    assert port._step_plans == ref._step_plans
    assert port._step_plans == ref_step_plans(ref._linear_banks,
                                              ref._kernel_banks, 6)
    assert len(port._step_plans) == 5
    for (rows, mask), (r_rows, r_mask) in zip(port._row_maps, ref._row_maps):
        np.testing.assert_array_equal(rows.numpy(), np.asarray(r_rows))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(r_mask))


def test_step_plans_equal_reference_on_analog_banks():
    ref, port, _ = _analog_machines()
    assert any(b.kind == "hw" for b in port._kernel_banks)
    assert port._step_plans == ref._step_plans


@pytest.mark.parametrize("build", ["mixed", "analog"])
def test_dag_labels_equal_reference(build):
    if build == "mixed":
        ref, port, x = _machines(6, decider="dag")
    else:
        ref, port, x = _analog_machines()
    got = port.predict(x)
    np.testing.assert_array_equal(got, ref.predict(x))
    np.testing.assert_array_equal(
        got, tovo.decide_dag(port.predict_bits(x), port.n_classes))
    np.testing.assert_array_equal(port.predict_votes(x), ref.predict_votes(x))


@pytest.mark.parametrize("build", ["mixed", "analog"])
def test_planned_dag_equals_unplanned(build):
    """The step plans drop only zero-coefficient terms and banks that own no
    reachable pair: the same labels as the unplanned gather front and as
    the host reference on the dense bits."""
    if build == "mixed":
        _, port, x = _machines(6, decider="dag")
    else:
        _, port, x = _analog_machines()
    xt = port._as_input(x)
    got = port.predict(x)
    unplanned = tcompiled._dag_labels(
        xt, port.n_classes, port._pair_matrix, port._linear_banks,
        port._kernel_banks, port._row_maps, None).numpy()
    np.testing.assert_array_equal(got, unplanned)
    np.testing.assert_array_equal(
        got, tovo.decide_dag(port.predict_bits(x), port.n_classes))


def test_quantized_bank_with_interior_zero_coefficients():
    """A digital RBF bank quantizes some coefficients to exactly 0 between
    nonzero ones.  The port's step plans keep every slot up to each pair's
    last nonzero coefficient, so its DAG labels equal ``decide_dag`` of the
    dense bits; the reference slices to the COUNT of nonzero coefficients,
    drops real support vectors and misses it (a fault of the reference,
    recorded in ROADMAP.md section C)."""
    k = 5
    rng = np.random.RandomState(0)
    x = rng.rand(300, 3)
    y = rng.randint(0, k, 300)
    models = []
    for ci, cj in rovo.class_pairs(k):
        mask = (y == ci) | (y == cj)
        yy = np.where(y[mask] == ci, 1.0, -1.0)
        models.append(rsvm.train_binary(x[mask], yy, "rbf", gamma=20.0,
                                        c=1000.0, n_epochs=40,
                                        use_pallas=False))
    ref = ref_compile([rovo.DigitalRBFClassifier.deploy(m) for m in models],
                      n_classes=k, use_pallas=False, decider="dag")
    port = compile_machine(
        [tovo.DigitalRBFClassifier.deploy(_port_model(m)) for m in models],
        n_classes=k, device="cpu", decider="dag")
    coef = port._kernel_banks[0].coef_pos.numpy()
    interior = [(c[:np.flatnonzero(c)[-1]] == 0).any() for c in coef]
    assert any(interior)
    bits = port.predict_bits(x)
    np.testing.assert_array_equal(port.predict(x), tovo.decide_dag(bits, k))
    assert all(a[0] >= b[0]
               for a, b in zip(port._step_plans, ref._step_plans))
    assert port._step_plans != ref._step_plans
    ref_bits = ref.predict_bits(x)
    assert (ref.predict(x) != rovo.decide_dag(ref_bits, k)).any()


def test_gather_scores_equal_dense_scores():
    """Each step's gathered score of the pair a sample consults equals the
    dense path's score of that pair (the hw gather runs the dense path's
    elementwise arithmetic; rbf runs K1's plain version)."""
    for _, port, x in (_machines(6, decider="dag"), _analog_machines()):
        xt = port._as_input(x)
        dense = port.decision_scores(x)
        n = xt.shape[0]
        xq = {}
        for b in list(port._linear_banks) + list(port._kernel_banks):
            xq.setdefault(b.input_bits, xt if b.input_bits == 0 else
                          tcompiled.quant.quantize_unit(xt, b.input_bits))
        rng = np.random.RandomState(1)
        p = rng.randint(0, port.n_pairs, n)
        got = tcompiled._gather_pair_scores(
            torch.as_tensor(p), port._linear_banks, port._kernel_banks,
            port._row_maps, xq).numpy()
        np.testing.assert_allclose(got, dense[np.arange(n), p],
                                   atol=1e-5, rtol=1e-5)


def test_compiled_dag_matches_host_reference():
    _, machine, x = _machines(6, mixed=False, decider="dag")
    bits = machine.predict_bits(x)
    np.testing.assert_array_equal(machine.predict(x),
                                  tovo.decide_dag(bits, 6))
    np.testing.assert_array_equal(machine.predict_votes(x),
                                  tovo.decide_votes(bits, 6))
    mask = tovo.condorcet_mask(bits, 6)
    np.testing.assert_array_equal(machine.predict(x)[mask],
                                  machine.predict_votes(x)[mask])
    assert machine.dag_votes_agreement(x) >= float(np.mean(mask))


def test_votes_decider_identical_to_default():
    _, m_default, x = _machines(5, mixed=False)
    _, m_votes, _ = _machines(5, mixed=False, decider="votes")
    _, m_dag, _ = _machines(5, mixed=False, decider="dag")
    assert m_default.decider == "votes"
    np.testing.assert_array_equal(m_default.predict(x), m_votes.predict(x))
    np.testing.assert_array_equal(m_default.predict(x),
                                  m_dag.predict_votes(x))
    assert m_default.n_linear_pairs == 10 and m_default.n_kernel_pairs == 0
    _, mixed, _ = _machines(5)
    assert (mixed.n_linear_pairs, mixed.n_kernel_pairs) == (5, 5)


def test_decider_validation_and_votes_oracle_guard():
    assert DECIDERS == ("votes", "dag")
    with pytest.raises(ValueError, match="decider"):
        _machines(3, mixed=False, decider="nope")
    _, m_votes, x = _machines(3, mixed=False)
    with pytest.raises(ValueError):
        m_votes.dag_votes_agreement(x)


def test_decider_save_load_roundtrip(tmp_path):
    _, m_dag, x = _machines(5, decider="dag")
    path = str(tmp_path / "dag_machine")
    m_dag.save(path)
    loaded = CompiledMachine.load(path, device="cpu")
    assert loaded.decider == "dag"
    np.testing.assert_array_equal(loaded.predict(x), m_dag.predict(x))
    as_votes = CompiledMachine.load(path, device="cpu", decider="votes")
    assert as_votes.decider == "votes"
    np.testing.assert_array_equal(as_votes.predict(x),
                                  m_dag.predict_votes(x))


@pytest.mark.parametrize("build", ["mixed", "analog"])
def test_reference_dag_save_loads_in_port(tmp_path, build):
    """A reference save written with ``"decider": "dag"`` loads in the port
    (its constructor refused the decider before) and predicts the
    reference's labels."""
    if build == "mixed":
        ref, _, x = _machines(6, decider="dag")
    else:
        ref, _, x = _analog_machines()
    path = str(tmp_path / "ref_dag")
    ref.save(path)
    port = CompiledMachine.load(path, device="cpu")
    assert port.decider == "dag"
    scores = ref.decision_scores(x)
    assert (np.abs(scores) > TIE_EPS).all()
    np.testing.assert_array_equal(port.predict(x), ref.predict(x))
    np.testing.assert_array_equal(port.predict_votes(x), ref.predict_votes(x))


# -- the estimator ---------------------------------------------------------------


@pytest.fixture(scope="module")
def small_estimator():
    rng = np.random.RandomState(3)
    x = rng.rand(120, 3)
    y = (x[:, 0] * 4).astype(int).clip(0, 3)
    est = MixedKernelSVM(n_epochs=20, cv_epochs=10, seed=0,
                         device="cpu").fit(x, y)
    return est, x


def test_estimator_deploy_caches_per_decider(small_estimator):
    est, x = small_estimator
    m_votes = est.deploy("circuit")
    m_dag = est.deploy("circuit", decider="dag")
    assert m_votes.decider == "votes" and m_dag.decider == "dag"
    assert m_dag is not m_votes
    assert est.deploy("circuit", decider="dag") is m_dag
    assert est.deploy("circuit", decider="votes") is m_votes
    assert {"circuit", "circuit@dag"} <= set(est._compiled)
    np.testing.assert_array_equal(m_dag.predict_votes(x), m_votes.predict(x))
    np.testing.assert_array_equal(
        m_dag.predict(x), tovo.decide_dag(m_votes.predict_bits(x), 4))


def test_estimator_deploy_assignment_caches_per_decider(small_estimator):
    est, x = small_estimator
    kmap = ["rbf" if i % 2 else "linear" for i in range(6)]
    m_votes = est.deploy_assignment(kmap)
    m_dag = est.deploy_assignment(kmap, decider="dag")
    assert m_dag.decider == "dag" and m_votes.decider == "votes"
    assert est.deploy_assignment(kmap, decider="dag") is m_dag
    key = "assignment:" + "".join("r" if k == "rbf" else "l" for k in kmap)
    assert {key, key + "@dag"} <= set(est._compiled)
    np.testing.assert_array_equal(
        m_dag.predict(x), tovo.decide_dag(m_votes.predict_bits(x), 4))

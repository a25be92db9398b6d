"""The port's foundations against the JAX reference, module by module.

Same seeded numpy inputs through ``repro`` and ``repro_torch`` (on the
CPU): datasets byte for byte, quantization exactly, kernel math and the
analog calibration to f32, the OvO datapaths and the cost model exactly on
identical banks, and the SVM entry points to solver tolerance.  Also: the
port imports neither JAX nor the reference package.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analog as ranalog
from repro.core import hwcost as rhw
from repro.core import kernels as rkern
from repro.core import ovo as rovo
from repro.core import quant as rquant
from repro.core import svm as rsvm
from repro.core import trainer as rtrainer
from repro.data import datasets as rds
from repro_torch.core import analog as tanalog
from repro_torch.core import hwcost as thw
from repro_torch.core import kernels as tkern
from repro_torch.core import ovo as tovo
from repro_torch.core import quant as tquant
from repro_torch.core import svm as tsvm
from repro_torch.core import trainer as ttrainer
from repro_torch.data import datasets as tds
from repro_torch.device import resolve_device


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _j(a):
    return jnp.asarray(np.asarray(a), jnp.float32)


def reference_hw_offsets(seed: int = 0):
    """The reference's fabricated-core draws for ``default_hw(seed)``."""
    kg, ka = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.normal(kg, (4,))),
            np.asarray(jax.random.normal(ka, (2,))))


# -- datasets --------------------------------------------------------------------


@pytest.mark.parametrize("name", ["balance", "seeds", "vertebral", "har12"])
def test_datasets_byte_identical(name):
    a, b = rds.load(name), tds.load(name)
    assert (a.name, a.n_classes) == (b.name, b.n_classes)
    for field in ("x_train", "y_train", "x_test", "y_test", "feature_idx"):
        ra, tb = getattr(a, field), getattr(b, field)
        assert ra.dtype == tb.dtype and ra.shape == tb.shape
        assert ra.tobytes() == tb.tobytes(), field


# -- quant ------------------------------------------------------------------------


def test_quantize_unit_and_codes_equal():
    rng = np.random.RandomState(0)
    x = (rng.rand(300) * 1.4 - 0.2).astype(np.float32)
    x[:5] = [0.0, 1.0, 0.5 / 15, 1.5 / 15, 7.5 / 15]   # ties round to even
    for bits in (1, 4, 8):
        np.testing.assert_array_equal(
            tquant.quantize_unit(_t(x), bits).numpy(),
            np.asarray(rquant.quantize_unit(_j(x), bits)))
        np.testing.assert_array_equal(
            tquant.quantize_unit_codes(_t(x), bits).numpy(),
            np.asarray(rquant.quantize_unit_codes(_j(x), bits)))


@pytest.mark.parametrize("bits", [4, 8])
def test_fixed_point_equal(bits):
    rng = np.random.RandomState(bits)
    for scale in (1e-3, 0.7, 5.0, 300.0):
        x = rng.randn(40) * scale
        q_r, fp_r = rquant.quantize_tensor(x, bits)
        q_t, fp_t = tquant.quantize_tensor(x, bits)
        assert (fp_r.bits, fp_r.frac_bits) == (fp_t.bits, fp_t.frac_bits)
        np.testing.assert_array_equal(q_t, q_r)
        np.testing.assert_array_equal(fp_t.codes(x).numpy(),
                                      np.asarray(fp_r.codes(x)))
    assert tquant.best_frac_bits(np.zeros(3), bits) == \
        rquant.best_frac_bits(np.zeros(3), bits)


def test_best_frac_bits_subnormal_clamps_where_reference_raises():
    """ROADMAP queue C.1: qmax/amax overflows for a subnormal amax in the
    reference; the port's difference of logs clamps to the f32 range."""
    vals = np.asarray([2.225073858507e-311])
    with pytest.raises(OverflowError):
        rquant.best_frac_bits(vals, 4)
    assert tquant.best_frac_bits(vals, 4) == 126
    fp = tquant.FixedPoint(bits=4, frac_bits=126)
    assert float(fp.quantize(vals).abs().max()) <= 7 * fp.scale


def test_csd_helpers_equal():
    for code in range(-300, 300):
        assert tquant.csd_nonzero_digits(code) == \
            rquant.csd_nonzero_digits(code)
        assert tquant.weight_hardware_class(code) == \
            rquant.weight_hardware_class(code)


# -- kernel math --------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["linear", "rbf", "sech2"])
def test_kernel_matrix_equal(kind):
    rng = np.random.RandomState(1)
    x, z = rng.rand(23, 4), rng.rand(17, 4)
    got = tkern.kernel_matrix(kind, _t(x), _t(z), 2.5).numpy()
    want = np.asarray(rkern.kernel_matrix(kind, _j(x), _j(z), 2.5))
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=1e-5)


def test_interpolation_paths_equal():
    hw = ttrainer.default_hw(0)
    grid, curve = hw.dv_grid, hw.kernel_curve
    v = np.linspace(-0.5, 0.5, 1001).astype(np.float32)
    left, right = float(curve[0]), float(curve[-1])
    want = np.asarray(jnp.interp(_j(v), _j(grid), _j(curve), left=left,
                                 right=right))
    got = tkern.interp(_t(v), _t(grid), _t(curve), left=left, right=right)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
    fp_t, fp_r = tkern._grid_fast_path(grid), rkern._grid_fast_path(grid)
    assert fp_t == fp_r and fp_t["uniform_grid"]
    for uniform in (True, False):
        got = tkern.measured_cell(_t(v), _t(grid), _t(curve), left, right,
                                  uniform, fp_t["inv_step"])
        want = rkern.measured_cell(_j(v), _j(grid), _j(curve), left, right,
                                   uniform, jnp.float32(fp_r["inv_step"]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# -- analog calibration ----------------------------------------------------------------


def test_default_hw_with_reference_draws():
    """default_hw(0) with the reference's draws passed in: the same sweep
    grids, measured curves and fits to f32."""
    ref = rtrainer.default_hw(0)
    port = ttrainer.default_hw(0, offsets=reference_hw_offsets(0))
    np.testing.assert_array_equal(port.dv_grid, ref.dv_grid)
    np.testing.assert_array_equal(port.dva_grid, ref.dva_grid)
    np.testing.assert_allclose(port.kernel_curve, ref.kernel_curve,
                               atol=3e-7, rtol=0)
    np.testing.assert_allclose(port.alpha_curve, ref.alpha_curve,
                               atol=1e-7, rtol=0)
    for f in ("gamma0", "a0", "alpha_x0", "alpha_s"):
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f),
                                   rtol=1e-6)
    assert abs(port.mu - ref.mu) < 1e-8
    np.testing.assert_allclose(ttrainer.hw_gamma_grid(port),
                               rtrainer.hw_gamma_grid(ref), rtol=1e-6)


def test_default_hw_draws_are_seeded():
    a, b = ttrainer.default_hw(3), ttrainer.default_hw(3)
    np.testing.assert_array_equal(a.kernel_curve, b.kernel_curve)
    assert a.mu == b.mu
    assert ttrainer.default_hw(4).mu != a.mu


def _same_hw(ref):
    """The port's model with the reference model's calibrated fields."""
    return tanalog.AnalogRBFModel(
        tanalog.CircuitParams(), ref.dv_grid, ref.kernel_curve, ref.a0,
        ref.gamma0, ref.mu, ref.alpha_x0, ref.alpha_s, ref.dva_grid,
        ref.alpha_curve, ref.v_scale)


def test_analog_classifier_equal():
    ref_hw = rtrainer.default_hw(0)
    hw = _same_hw(ref_hw)
    rng = np.random.RandomState(3)
    sx = rng.rand(12, 3)
    model_kw = dict(kind="hw", support_x=sx, support_y=np.where(
        np.arange(12) % 3 == 0, -1.0, 1.0), alpha=rng.rand(12) * 4 + 0.01,
        bias=0.3, gamma=2.0, c=10.0)
    clf_r = ranalog.AnalogBinaryClassifier.deploy(
        rsvm.SVMModel(**model_kw), ref_hw)
    clf_t = tanalog.AnalogBinaryClassifier.deploy(
        tsvm.SVMModel(**model_kw), hw)
    x = rng.rand(50, 3)
    np.testing.assert_allclose(
        hw.kernel_response(_t(x), _t(sx), 2.0).numpy(),
        np.asarray(ref_hw.kernel_response(_j(x), _j(sx), 2.0)), atol=2e-6)
    for got, want in zip(clf_t.rail_currents(x, device="cpu"),
                         clf_r.rail_currents(x)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=1e-5)
    np.testing.assert_array_equal(clf_t.predict_bits(x, device="cpu"),
                                  clf_r.predict_bits(x))


# -- OvO + cost model ----------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_encoder_and_pair_index_equal(k):
    assert tovo.class_pairs(k) == rovo.class_pairs(k)
    np.testing.assert_array_equal(tovo.build_encoder_table(k),
                                  rovo.build_encoder_table(k))
    np.testing.assert_array_equal(tovo.pair_index_matrix(k),
                                  rovo.pair_index_matrix(k))


def _models(pkg, rng, n_pairs=3, d=4):
    out = []
    for p in range(n_pairs):
        m = 8 + p
        sx = rng.rand(m, d)
        sy = np.where(np.arange(m) % 2 == 0, 1.0, -1.0)
        alpha = rng.rand(m) * (3.0 + p) + 0.05
        lin = pkg.SVMModel(kind="linear", support_x=sx, support_y=sy,
                           alpha=alpha, bias=0.2 - 0.1 * p, gamma=1.0, c=5.0,
                           w=(alpha * sy) @ sx)
        rbf = pkg.SVMModel(kind="rbf", support_x=sx, support_y=sy,
                           alpha=alpha, bias=-0.05 * p, gamma=1.5 + p, c=5.0)
        out.append((lin, rbf))
    return out


def test_digital_classifiers_and_system_cost_equal():
    """Identical float models deployed through both packages: the same
    quantized constants, bits and Table-II cost."""
    pr = _models(rsvm, np.random.RandomState(9))
    pt = _models(tsvm, np.random.RandomState(9))
    ref_hw = rtrainer.default_hw(0)
    hw = _same_hw(ref_hw)
    x = np.random.RandomState(1).rand(64, 4)
    banks = {}
    for pkg_ovo, pkg_an, models, h, tag in (
            (rovo, ranalog, pr, ref_hw, "r"), (tovo, tanalog, pt, hw, "t")):
        lin = [pkg_ovo.DigitalLinearClassifier.deploy(m[0]) for m in models]
        rbf = [pkg_ovo.DigitalRBFClassifier.deploy(m[1]) for m in models]
        mixed = [lin[0],
                 pkg_an.AnalogBinaryClassifier.deploy(models[1][1], h),
                 lin[2]]
        banks[tag] = {
            name: pkg_ovo.MulticlassSVM(3, clfs, ["linear"] * 3)
            for name, clfs in (("linear", lin), ("rbf", rbf),
                               ("mixed", mixed))}
    for name in ("linear", "rbf", "mixed"):
        br, bt = banks["r"][name], banks["t"][name]
        for cr, ct in zip(br.classifiers, bt.classifiers):
            for f in ("w_q", "b_q", "support_x", "coef", "bias", "alpha_hw",
                      "bias_hw"):
                if hasattr(cr, f):
                    np.testing.assert_array_equal(getattr(ct, f),
                                                  getattr(cr, f))
        np.testing.assert_array_equal(bt.predict_bits(x, device="cpu"),
                                      br.predict_bits(x))
        cost_r = rhw.system_cost(br, rhw.CostModel())
        cost_t = thw.system_cost(bt, thw.CostModel())
        assert cost_t.__dict__ == cost_r.__dict__
    cal_r = rhw.calibrate_digital({"balance": banks["r"]["linear"]})
    cal_t = thw.calibrate_digital({"balance": banks["t"]["linear"]})
    assert cal_t.__dict__ == cal_r.__dict__
    assert thw.TABLE2 == rhw.TABLE2 and thw.TABLE2_LINEAR == rhw.TABLE2_LINEAR


# -- SVM entry points ----------------------------------------------------------------


def test_fit_best_matches_reference():
    rng = np.random.RandomState(7)
    x = rng.rand(60, 3)
    y = np.where(x[:, 0] + 0.3 * x[:, 1] > 0.7, 1.0, -1.0)
    kw = dict(gammas=np.logspace(-1, 1, 3), cs=np.logspace(-1, 1, 3),
              n_folds=3, n_epochs=40, cv_epochs=20)
    m_r, acc_r = rsvm.fit_best(x, y, "rbf", use_pallas=False, **kw)
    m_t, acc_t = tsvm.fit_best(x, y, "rbf", device="cpu", **kw)
    assert (m_t.gamma, m_t.c) == (m_r.gamma, m_r.c)
    np.testing.assert_allclose(acc_t, acc_r, atol=1e-6)
    np.testing.assert_array_equal(m_t.support_x, m_r.support_x)
    np.testing.assert_allclose(m_t.alpha, m_r.alpha, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(tsvm.decision_function(m_t, x, "cpu"),
                               rsvm.decision_function(m_r, x), atol=5e-3)


def test_train_binary_hw_callable_matches_reference():
    ref_hw = rtrainer.default_hw(0)
    hw = _same_hw(ref_hw)
    rng = np.random.RandomState(2)
    x = rng.rand(40, 2)
    y = np.where(x[:, 0] > x[:, 1], 1.0, -1.0)
    m_r = rsvm.train_binary(x, y, ref_hw.kernel_response, gamma=3.0, c=5.0,
                            n_epochs=30)
    m_t = tsvm.train_binary(x, y, hw.kernel_response, gamma=3.0, c=5.0,
                            n_epochs=30, device="cpu")
    assert m_t.kind == "hw" and m_t.kernel_fn == hw.kernel_response
    np.testing.assert_array_equal(m_t.support_x, m_r.support_x)
    np.testing.assert_allclose(m_t.alpha, m_r.alpha, atol=5e-4, rtol=1e-3)


def test_dual_coordinate_ascent_matches_reference():
    rng = np.random.RandomState(5)
    x = rng.rand(30, 2)
    y = np.where(rng.rand(30) > 0.5, 1.0, -1.0)
    kp = np.asarray(rkern.kernel_matrix("rbf", _j(x), _j(x), 2.0)) + 1.0
    c = np.full(30, 3.0)
    got = tsvm.dual_coordinate_ascent(_t(kp), _t(y), _t(c), 10)
    want = rsvm.dual_coordinate_ascent(_j(kp), _j(y), _j(c), 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                               rtol=1e-3)


# -- device policy and the import boundary ---------------------------------------------


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_no_jax_and_no_reference():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'repro' or n.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "walked = ('api.fleet', 'serving.svm_engine', 'launch.mesh',\n"
        "          'launch.serve_svm', 'models.mlp', 'models.convert',\n"
        "          'serving.engine', 'launch.serve', 'configs.base',\n"
        "          'configs.starcoder2_7b', 'configs.granite_20b',\n"
        "          'configs.qwen2_5_32b', 'configs.command_r_35b',\n"
        "          'configs.kimi_k2_1t_a32b', 'configs.granite_moe_1b_a400m',\n"
        "          'configs.phi_3_vision_4_2b', 'configs.mamba2_2_7b',\n"
        "          'configs.whisper_medium')\n"
        "missing = [m for m in walked if 'repro_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20

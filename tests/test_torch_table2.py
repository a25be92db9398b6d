"""A Table II dataset at full size and the estimator's defaults: the port
(``device="cpu"``) against the JAX reference (``use_pallas=False``).

Vertebral, n_epochs=200, 5 folds, the 7 x 7 grids, with the reference's
fabricated core passed in.  Its pair (0, 1) linear CV grid holds an exact
tie between two C cells that only the rounding of the fold mean breaks
(ROADMAP queue C.9), so this also pins the port's fold mean to the
reference's.
"""
import jax
import numpy as np
import pytest

from repro.api import MixedKernelSVM as RefSVM
from repro.core import hwcost as rhw
from repro.data import datasets as rds
from repro_torch.api import MixedKernelSVM
from repro_torch.core import hwcost as thw


@pytest.fixture(scope="module")
def vertebral():
    kg, ka = jax.random.split(jax.random.PRNGKey(0))
    offsets = (np.asarray(jax.random.normal(kg, (4,))),
               np.asarray(jax.random.normal(ka, (2,))))
    ds = rds.load("vertebral")
    ref = RefSVM(use_pallas=False).fit(ds.x_train, ds.y_train)
    port = MixedKernelSVM(device="cpu", hw_offsets=offsets).fit(
        ds.x_train, ds.y_train)
    return ds, ref, port


@pytest.mark.parametrize("slot", ["model_linear", "model_rbf", "model_hw"])
def test_same_selections_and_support_sets(vertebral, slot):
    _, ref, port = vertebral
    assert port.kernel_map_ == ref.kernel_map_
    for pr, pt in zip(ref.pairs_, port.pairs_):
        mr, mt = getattr(pr, slot), getattr(pt, slot)
        assert mt.c == mr.c, pr.pair
        np.testing.assert_allclose(mt.gamma, mr.gamma, rtol=1e-7)
        np.testing.assert_array_equal(mt.support_x, mr.support_x)


@pytest.mark.parametrize("target", ["float", "circuit", "linear", "rbf",
                                    "linear_float", "rbf_float"])
def test_same_table2_accuracy(vertebral, target):
    ds, ref, port = vertebral
    assert port.score(ds.x_test, ds.y_test, target) == \
        ref.score(ds.x_test, ds.y_test, target)


def test_same_table2_cost(vertebral):
    _, ref, port = vertebral
    for target in ("linear", "circuit", "rbf"):
        cr = rhw.system_cost(ref.bank(target), rhw.CostModel())
        ct = thw.system_cost(port.bank(target), thw.CostModel())
        np.testing.assert_allclose([ct.area_mm2, ct.power_mw],
                                   [cr.area_mm2, cr.power_mw], rtol=1e-12)

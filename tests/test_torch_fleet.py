"""The port's FleetMachine and its sharded forward against the JAX reference.

On the CPU (``device="cpu"``), at the shapes of tests/test_serving_svm.py
(hand-built machines, no training), mirrored case by case:

* inside the port, the co-batched forward equals each member machine bit
  for bit (scores as raw f32 bit patterns, bits, labels) across ragged
  members (different K, d, bank counts, an analog member), for the votes
  and the DAG fronts;
* per-row routing, input forms and errors, one-member fleets, the fleet's
  device (members on different devices are refused), save / load;
* against the reference on the same numpy inputs: fleets built in both
  packages from the same models, a reference fleet save loaded by the port
  and a port fleet save loaded by the reference: the same layout, scores
  within tests/test_torch_slice.py's tolerances (atol 1e-5, rtol 1e-5;
  measured-curve columns atol 1e-5 + 2e-7 sum|coef|), labels equal off
  ties (|score| > 1e-5);
* ``ShardedFleetForward`` over CPU serving meshes of 1-4 devices: every
  per-device slice equals the unsharded labels on the same rows bit for
  bit, ragged row counts pad and trim, and a mesh without the ``"batch"``
  axis is refused.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import FleetMachine as RefFleet
from repro.api import compile_fleet as ref_compile_fleet
from repro.api import compile_machine as ref_compile_machine
from repro.core import trainer as rtrainer
from repro.core.analog import AnalogBinaryClassifier as RefAnalog
from repro.core.svm import SVMModel as RefModel
from repro_torch.api import (
    CompiledMachine,
    FleetMachine,
    ShardedFleetForward,
    compile_fleet,
    compile_machine,
)
from repro_torch.core import analog as tanalog
from repro_torch.core import svm as tsvm
from repro_torch.launch import mesh as mesh_mod

TIE_EPS = 1e-5
HW_KERNEL_ULP = 2e-7


def _port_hw_of(ref_hw):
    """The port's behavioral model with the reference model's fields."""
    return tanalog.AnalogRBFModel(
        tanalog.CircuitParams(), ref_hw.dv_grid, ref_hw.kernel_curve,
        ref_hw.a0, ref_hw.gamma0, ref_hw.mu, ref_hw.alpha_x0, ref_hw.alpha_s,
        ref_hw.dva_grid, ref_hw.alpha_curve, ref_hw.v_scale)


_REF_HW = rtrainer.default_hw(0)
_PORT_HW = _port_hw_of(_REF_HW)


def _pair_model(pkg, gen, d, m, kind):
    sx = gen.normal(size=(m, d)).astype(np.float32)
    sy = np.where(np.arange(m) % 2 == 0, 1.0, -1.0).astype(np.float32)
    alpha = (np.abs(gen.normal(size=m)) + 0.1).astype(np.float32)
    kw = {}
    if kind == "linear":
        kw["w"] = ((alpha * sy) @ sx).astype(np.float32)
    model = RefModel if pkg == "ref" else tsvm.SVMModel
    return model(kind=kind, support_x=sx, support_y=sy, alpha=alpha,
                 bias=float(gen.normal() * 0.1), gamma=0.7, c=1.0, **kw)


def tiny_machine(seed, d=3, m=6, n_classes=3, analog_pairs=(), pkg="port",
                 decider="votes"):
    """tests/test_serving_svm.py::tiny_machine in either package (the analog
    pairs around the reference's calibrated core in both)."""
    gen = np.random.default_rng(seed)
    n_pairs = n_classes * (n_classes - 1) // 2
    clfs = []
    for p in range(n_pairs):
        kind = "linear" if p % 2 == 0 else "rbf"
        model = _pair_model(pkg, gen, d, m, kind)
        if p in analog_pairs:
            model = _pair_model(pkg, gen, d, m, "rbf")
            model = RefAnalog.deploy(model, _REF_HW) if pkg == "ref" else \
                tanalog.AnalogBinaryClassifier.deploy(model, _PORT_HW)
        clfs.append(model)
    if pkg == "ref":
        return ref_compile_machine(clfs, n_classes=n_classes,
                                   decider=decider)
    return compile_machine(clfs, n_classes=n_classes, device="cpu",
                           decider=decider)


RAGGED = {"tiny": dict(seed=0, d=3, m=6, n_classes=3),
          "wide": dict(seed=1, d=5, m=8, n_classes=4),
          "analog": dict(seed=2, d=4, m=6, n_classes=3, analog_pairs=(1,))}


def _ragged_members(pkg="port", decider="votes"):
    return {k: tiny_machine(**kw, pkg=pkg, decider=decider)
            for k, kw in RAGGED.items()}


@pytest.fixture(scope="module")
def ragged_fleet():
    members = _ragged_members()
    return compile_fleet(members), members


@pytest.fixture(scope="module")
def ref_ragged_fleet():
    members = _ragged_members("ref")
    return ref_compile_fleet(members), members


def _queries(gen, n, d):
    return gen.normal(size=(n, d)).astype(np.float32)


def _hw_mass(ref_machine) -> np.ndarray:
    mass = np.zeros(ref_machine.n_pairs)
    for bank in ref_machine._kernel_banks:
        if bank.kind == "hw":
            mass[np.asarray(bank.pair_idx)] = (
                np.abs(np.asarray(bank.coef_pos)).sum(1)
                + np.abs(np.asarray(bank.coef_neg)).sum(1))
    return mass


def _assert_scores(got, want, hw_mass):
    atol = 1e-5 + HW_KERNEL_ULP * np.asarray(hw_mass)
    bad = np.abs(got - want) > atol + 1e-5 * np.abs(want)
    assert not bad.any(), (np.abs(got - want).max(), np.argwhere(bad)[:5])


def _assert_labels_off_ties(got, want, scores):
    clear = (np.abs(scores) > TIE_EPS).all(axis=1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])


# -- FleetMachine inside the port ----------------------------------------------


def test_fleet_layout(ragged_fleet):
    fleet, members = ragged_fleet
    assert fleet.model_ids == ["tiny", "wide", "analog"]
    assert fleet.n_features == 5            # d_max over members
    assert fleet.n_pairs_total == 3 + 6 + 3
    assert fleet.pair_slice("tiny") == (0, 3)
    assert fleet.pair_slice("wide") == (3, 9)
    assert fleet.pair_slice("analog") == (9, 12)
    assert fleet.member("wide") is members["wide"]
    assert fleet.device == torch.device("cpu")
    assert "FleetMachine(3 models" in fleet.describe()
    assert fleet.to("cpu") is fleet


@pytest.mark.parametrize("decider", ["votes", "dag"])
def test_fleet_bit_identical_to_members(decider):
    """Scores, bits and labels of the co-batched forward equal each member
    machine's bit for bit (the labels through the fleet's decider equal a
    member built with the same decider)."""
    members = _ragged_members(decider=decider)
    fleet = compile_fleet(members, decider=decider)
    gen = np.random.default_rng(7)
    for mid, machine in members.items():
        x = _queries(gen, 17, machine.n_features)
        want = machine.decision_scores(x)
        got = fleet.decision_scores(x, mid)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        np.testing.assert_array_equal(fleet.predict_bits(x, mid),
                                      machine.predict_bits(x))
        np.testing.assert_array_equal(fleet.predict(x, mid),
                                      machine.predict(x))
        np.testing.assert_array_equal(fleet.predict_votes(x, mid),
                                      machine.predict_votes(x))


def test_fleet_per_row_routing(ragged_fleet):
    """A mixed batch routed per row gives each row its own member's label."""
    fleet, members = ragged_fleet
    gen = np.random.default_rng(11)
    ids = [fleet.model_ids[i] for i in gen.integers(0, 3, size=29)]
    x = _queries(gen, 29, fleet.n_features)
    got = fleet.predict(x, ids)
    assert got.dtype == np.int32
    for r, mid in enumerate(ids):
        m = members[mid]
        want = m.predict(x[r:r + 1, : m.n_features])[0]
        assert got[r] == want, f"row {r} ({mid}): {got[r]} != {want}"


def test_fleet_single_member_wraps_machine():
    machine = tiny_machine(3)
    fleet = compile_fleet([machine])           # bare sequence, default ids
    assert fleet.model_ids == ["model0"]
    gen = np.random.default_rng(0)
    x = _queries(gen, 9, machine.n_features)
    np.testing.assert_array_equal(fleet.predict(x, 0), machine.predict(x))


def test_fleet_input_forms_and_errors():
    a, b = tiny_machine(4), tiny_machine(5)
    by_pairs = compile_fleet([("a", a), ("b", b)])
    assert by_pairs.model_ids == ["a", "b"]
    with pytest.raises(ValueError, match="duplicate"):
        FleetMachine(["a", "a"], [a, b])
    with pytest.raises(TypeError, match="CompiledMachine"):
        compile_fleet({"a": a, "bad": object()})
    with pytest.raises(ValueError, match="decider"):
        compile_fleet({"a": a}, decider="tree")
    fleet = compile_fleet({"a": a, "b": b})
    with pytest.raises(KeyError, match="unknown model id"):
        fleet.model_index("missing")
    with pytest.raises(IndexError):
        fleet.model_index(2)
    with pytest.raises(ValueError, match="expected"):
        fleet.predict(np.zeros((4, fleet.n_features + 1), np.float32), "a")
    with pytest.raises(ValueError, match="model ids"):
        fleet.predict(np.zeros((4, 3), np.float32), ["a", "b"])


def test_fleet_refuses_members_on_different_devices():
    """A fleet takes its members' device: members elsewhere are refused,
    never moved behind the caller's back."""
    a = tiny_machine(4)
    elsewhere = copy.copy(tiny_machine(5))
    elsewhere.device = torch.device("cuda", 1)
    with pytest.raises(ValueError, match="different devices"):
        compile_fleet({"a": a, "b": elsewhere})


def test_fleet_save_load_round_trip(tmp_path, ragged_fleet):
    fleet, members = ragged_fleet
    path = str(tmp_path / "fleet")
    fleet.save(path)
    back = FleetMachine.load(path, device="cpu")
    assert back.model_ids == fleet.model_ids
    assert back._pair_slices == fleet._pair_slices
    assert back.decider == "votes"
    gen = np.random.default_rng(13)
    for mid, machine in members.items():
        x = _queries(gen, 11, machine.n_features)
        np.testing.assert_array_equal(
            back.decision_scores(x, mid).view(np.int32),
            fleet.decision_scores(x, mid).view(np.int32))
        np.testing.assert_array_equal(back.predict(x, mid),
                                      machine.predict(x))
    assert FleetMachine.load(path, device="cpu", decider="dag").decider == \
        "dag"
    members["tiny"].save(str(tmp_path / "one"))
    with pytest.raises(ValueError, match="not a FleetMachine"):
        FleetMachine.load(str(tmp_path / "one"), device="cpu")


# -- against the reference -------------------------------------------------------


def _assert_fleet_matches_reference(port_fleet, ref_fleet, ref_members,
                                    seed):
    """Scores within tolerance, labels off ties, routed labels off ties."""
    assert port_fleet.model_ids == list(ref_fleet.model_ids)
    assert port_fleet._pair_slices == ref_fleet._pair_slices
    assert port_fleet.n_features == ref_fleet.n_features
    gen = np.random.default_rng(seed)
    for mid, rm in ref_members.items():
        x = _queries(gen, 23, rm.n_features)
        want = np.asarray(ref_fleet.decision_scores(x, mid))
        got = port_fleet.decision_scores(x, mid)
        _assert_scores(got, want, _hw_mass(rm))
        _assert_labels_off_ties(port_fleet.predict(x, mid),
                                np.asarray(ref_fleet.predict(x, mid)), want)
    ids = [port_fleet.model_ids[i] for i in gen.integers(0, 3, size=31)]
    x = _queries(gen, 31, port_fleet.n_features)
    clear = np.ones(31, bool)
    for r, mid in enumerate(ids):
        rm = ref_members[mid]
        s = np.asarray(rm.decision_scores(x[r:r + 1, : rm.n_features]))
        clear[r] = (np.abs(s) > TIE_EPS).all()
    np.testing.assert_array_equal(port_fleet.predict(x, ids)[clear],
                                  np.asarray(ref_fleet.predict(x, ids))[clear])


@pytest.mark.parametrize("decider", ["votes", "dag"])
def test_fleet_matches_reference_fleet(decider, ref_ragged_fleet):
    _, ref_members = ref_ragged_fleet
    ref_fleet = ref_compile_fleet(ref_members, decider=decider)
    port_fleet = compile_fleet(_ragged_members(), decider=decider)
    _assert_fleet_matches_reference(port_fleet, ref_fleet, ref_members, 3)


def test_reference_fleet_save_loads_in_port(tmp_path, ref_ragged_fleet):
    ref_fleet, ref_members = ref_ragged_fleet
    path = str(tmp_path / "ref_fleet")
    ref_fleet.save(path)
    port_fleet = FleetMachine.load(path, device="cpu")
    assert port_fleet.decider == "votes"
    assert [m.kernel_map for m in port_fleet._members] == \
        [m.kernel_map for m in ref_fleet._members]
    _assert_fleet_matches_reference(port_fleet, ref_fleet, ref_members, 5)


def test_port_fleet_save_loads_in_reference(tmp_path, ragged_fleet,
                                            ref_ragged_fleet):
    fleet, _ = ragged_fleet
    _, ref_members = ref_ragged_fleet
    path = str(tmp_path / "port_fleet")
    compile_fleet(fleet._members, decider="dag").save(path)
    ref_back = RefFleet.load(path)
    assert ref_back.decider == "dag"
    ref_members = dict(zip(ref_back.model_ids, ref_back._members))
    _assert_fleet_matches_reference(
        compile_fleet(dict(zip(ref_back.model_ids, fleet._members)),
                      decider="dag"), ref_back, ref_members, 9)


# -- the sharded forward on CPU serving meshes ----------------------------------


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_sharded_fleet_forward_per_slice_bit_identity(n_dev, ragged_fleet):
    fleet, _ = ragged_fleet
    mesh = mesh_mod.make_serving_mesh(devices=["cpu"] * n_dev)
    fwd = fleet.shard(mesh)
    assert isinstance(fwd, ShardedFleetForward)
    assert fleet.shard(mesh) is fwd               # cached per mesh
    assert fwd.n_devices == n_dev and fwd.replicas[0] is fleet
    gen = np.random.default_rng(n_dev)
    n = fwd.global_rows(16)
    x = fleet._pad_features(_queries(gen, n, fleet.n_features))
    idx = fleet._resolve_idx(
        [fleet.model_ids[i] for i in gen.integers(0, 3, size=n)], n)
    sharded = fwd(x, idx)
    local = fleet._labels(torch.as_tensor(x), torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(sharded, local)
    per = n // n_dev
    for dev in range(n_dev):
        s = slice(dev * per, (dev + 1) * per)
        np.testing.assert_array_equal(
            sharded[s], fleet._labels(torch.as_tensor(x[s]),
                                      torch.as_tensor(idx[s])).numpy())
    if n_dev > 1:
        with pytest.raises(ValueError, match="divisible"):
            fwd(x[:-1], idx[:-1])
    # ragged row count: predict pads to whole slices and trims
    x27 = _queries(gen, 27, 4)
    np.testing.assert_array_equal(fwd.predict(x27, "analog"),
                                  fleet.predict(x27, "analog"))


def test_serving_mesh_requires_batch_axis(ragged_fleet):
    fleet, _ = ragged_fleet
    m = mesh_mod.make_test_mesh(shape=(1,), axes=("data",))
    with pytest.raises(ValueError, match="batch"):
        fleet.shard(m)


def test_mesh_types():
    m = mesh_mod.make_serving_mesh(devices=["cpu"] * 3)
    assert m.axis_names == (mesh_mod.SERVING_AXIS,) == ("batch",)
    assert m.shape == {"batch": 3} and m.size == 3
    assert m == mesh_mod.make_serving_mesh(devices=["cpu"] * 3)
    assert hash(m) == hash(mesh_mod.make_serving_mesh(devices=["cpu"] * 3))
    assert mesh_mod.make_variant_mesh(devices=["cpu"]).shape == {
        "variants": 1}
    assert mesh_mod.make_trainer_mesh(devices=["cpu"] * 2).shape == {
        "pairgrid": 2}
    two_d = mesh_mod.make_test_mesh()
    assert two_d.shape == {"data": 2, "model": 4} and two_d.size == 8
    assert two_d == mesh_mod.make_test_mesh(shape=(2, 4),
                                            axes=("data", "model"))
    # A 1-D consumer refuses a multi-axis mesh, even one holding its axis.
    batch_2d = mesh_mod.make_test_mesh(shape=(2, 4), axes=("batch", "model"))
    with pytest.raises(ValueError, match="1-D mesh over 'batch'"):
        mesh_mod.require_axis(batch_2d, "batch", "make_serving_mesh")
    with pytest.raises(ValueError, match="n_devices"):
        mesh_mod.make_serving_mesh(2, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            mesh_mod.make_serving_mesh()
    with pytest.raises(dataclasses.FrozenInstanceError):
        m.devices = ()


def test_compiled_machine_to_same_device_is_itself():
    m = tiny_machine(6)
    assert m.to("cpu") is m
    assert isinstance(m, CompiledMachine)

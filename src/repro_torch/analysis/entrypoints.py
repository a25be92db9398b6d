"""Registry of the port's hot entry points for Pass 1 (``dispatch_checks``).

The port's counterpart of ``repro/analysis/entrypoints.py``.  Every entry
builds the real object path (hand-built ``SVMModel`` banks, the calibrated
analog behavioural model, the compiled machines, the fleet, its sharded
leg and the serving engine) at tiny deterministic shapes, with no
training, on the device the caller gives, and exposes one call of the
function the production code runs per batch.  PyTorch runs eagerly, so
Pass 1 runs each entry once under a dispatch recorder instead of tracing
it.

``HOT_SYMBOLS`` lists the same functions by file and qualified name; the
AST pass's BANNED-IN-HOT reads it without building anything.  Registering
a new hot entry point: add it to both.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.analysis.dispatch_checks import MAX_UPLOAD_BYTES

_API = "src/repro_torch/api/compiled.py"
_FLEET = "src/repro_torch/api/fleet.py"
_TRAINER = "src/repro_torch/core/trainer.py"

#: (path, qualified name) of every registered hot function.
HOT_SYMBOLS = (
    (_API, "CompiledMachine.forward"),
    (_API, "CompiledMachine._labels_dag"),
    (_API, "CandidateMachine.forward"),
    (_API, "MonteCarloMachine.forward"),
    (_API, "StreamingMCMachine._chunk_bits"),
    ("src/repro_torch/core/mcstream.py", "update_stream"),
    (_FLEET, "FleetMachine._forward"),
    (_FLEET, "FleetMachine._labels"),
    (_FLEET, "ShardedFleetForward.enqueue"),
    ("src/repro_torch/core/dse.py", "_votes_accuracy_paired"),
    (_TRAINER, "_cv_grid_all_pairs"),
    (_TRAINER, "_refit_all_pairs"),
    ("src/repro_torch/kernels/ops.py", "solve_lanes"),
    ("src/repro_torch/serving/svm_engine.py", "SVMEngine._forward"),
)


@dataclasses.dataclass
class EntryPoint:
    """One hot call plus everything Pass 1 needs.

    ``fn()`` runs one call on the registry's device and returns its
    outputs: tensors, or the launches to wait on where the entry enqueues
    asynchronous work (the sharded leg and the engine).  ``engine`` is set on the serving engine's entry, whose slot
    contract (SLOT-REUSE) Pass 1 also checks."""

    symbol: str
    path: str
    fn: Callable[[], object]
    max_upload_bytes: int = MAX_UPLOAD_BYTES
    engine: Optional[object] = None


def _tiny_models():
    """Deterministic hand-built per-pair models — no training involved
    (the reference registry's, array for array)."""
    from repro_torch.core.svm import SVMModel

    rng = np.random.default_rng(0)
    d, m = 3, 6
    sx = rng.normal(size=(m, d)).astype(np.float32)
    sy = np.array([1, -1, 1, -1, 1, -1], np.float32)
    alpha = (np.abs(rng.normal(size=m)) + 0.1).astype(np.float32)
    w = ((alpha * sy) @ sx).astype(np.float32)
    lin = SVMModel(kind="linear", support_x=sx, support_y=sy, alpha=alpha,
                   bias=0.1, gamma=1.0, c=1.0, w=w)
    rbf = SVMModel(kind="rbf", support_x=sx, support_y=sy, alpha=alpha,
                   bias=-0.05, gamma=0.7, c=1.0)
    return lin, rbf


def build_registry(device=None) -> list[EntryPoint]:
    """Every hot entry point, built on ``device`` (the card when ``None``)
    at the reference registry's tiny shapes (8 rows, d = 3, K = 3)."""
    from repro_torch.api import compiled as api
    from repro_torch.api import fleet as fleet_mod
    from repro_torch.core import dse, mcstream, trainer
    from repro_torch.core.analog import AnalogBinaryClassifier
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.svm_engine import SVMEngine

    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    entries: list[EntryPoint] = []
    lin, rbf = _tiny_models()
    d = lin.support_x.shape[1]
    hw_clf = AnalogBinaryClassifier.deploy(rbf, trainer.default_hw(0))
    x_in = torch.zeros((8, d), **f32)

    machine = api.compile_machine([lin, rbf, hw_clf], n_classes=3,
                                  device=dev)
    entries.append(EntryPoint("CompiledMachine.forward", _API,
                              lambda: machine.forward(x_in)))

    machine_dag = api.compile_machine([lin, rbf, hw_clf], n_classes=3,
                                      decider="dag", device=dev)
    entries.append(EntryPoint("CompiledMachine._labels_dag", _API,
                              lambda: machine_dag._labels_dag(x_in)))

    cands = [(lin, rbf), (lin, rbf), (lin, hw_clf)]
    cand_machine = api.compile_candidates(cands, n_classes=3, device=dev)
    entries.append(EntryPoint("CandidateMachine.forward", _API,
                              lambda: cand_machine.forward(x_in)))

    mc_machine = api.compile_variants(cands, n_classes=3, key=0,
                                      n_variants=4, device=dev)
    entries.append(EntryPoint("MonteCarloMachine.forward", _API,
                              lambda: mc_machine.forward(x_in)))

    # -- the streamed Monte-Carlo chunk: draws -> bits, then the fold -------
    sm = api.compile_mc_stream(cands, n_classes=3, key=0, mc_chunk=4,
                               device=dev)
    v_idx = torch.arange(4, dtype=torch.int64, device=dev)
    u = sm._uniforms(0, 4)
    entries.append(EntryPoint("StreamingMCMachine._chunk_bits", _API,
                              lambda: sm._chunk_bits(x_in, v_idx, u)))
    state = mcstream.init_stream(1, mcstream.hist_bins(8), dev)
    acc = torch.full((4, 1), 0.5, **f32)
    ones = torch.ones((4,), **f32)
    entries.append(EntryPoint(
        "update_stream", "src/repro_torch/core/mcstream.py",
        lambda: mcstream.update_stream(state, acc, ones, ones, 0.5)))

    # -- the fleet, its sharded leg and the serving engine ------------------
    machine_b = api.compile_machine([rbf, lin, hw_clf], n_classes=3,
                                    device=dev)
    fleet = fleet_mod.compile_fleet({"m0": machine, "m1": machine_b})
    fleet_dag = fleet_mod.compile_fleet({"m0": machine, "m1": machine_b},
                                        decider="dag")
    idx_in = torch.tensor([0, 1] * 4, dtype=torch.int32, device=dev)
    entries.append(EntryPoint("FleetMachine._forward", _FLEET,
                              lambda: fleet._forward(x_in, idx_in)))
    entries.append(EntryPoint("FleetMachine._labels", _FLEET,
                              lambda: fleet._labels(x_in, idx_in)))
    entries.append(EntryPoint("FleetMachine._labels[dag]", _FLEET,
                              lambda: fleet_dag._labels(x_in, idx_in)))

    sharded = fleet.shard(make_serving_mesh(devices=[dev]))
    xh = fleet_mod.host_buffer((8, d), torch.float32, dev)
    ih = fleet_mod.host_buffer((8,), torch.int32, dev)
    out = fleet_mod.host_buffer((8,), torch.int32, dev)
    xh.zero_()
    ih.copy_(idx_in.cpu())
    entries.append(EntryPoint("ShardedFleetForward.enqueue", _FLEET,
                              lambda: sharded.enqueue(xh, ih, out)))

    engine = SVMEngine(fleet, max_batch=8, min_bucket=8)
    engine._order_after_banks()
    slot = engine._staging[8][0]
    slot.xv[:] = 0.0
    slot.iv[:] = np.tile([0, 1], 4)
    entries.append(EntryPoint(
        "SVMEngine._forward", "src/repro_torch/serving/svm_engine.py",
        lambda: engine._forward(slot), engine=engine))

    # -- the pair-chunked votes recombination (P > MAX_TABLE_BITS) ----------
    va6, vb6 = dse._vote_matrices(6, dev)
    rngb = np.random.default_rng(3)
    bits4 = torch.as_tensor(rngb.integers(0, 2, size=(2, 8, 15, 2)),
                            dtype=torch.int32, device=dev)
    assign = torch.as_tensor(rngb.integers(0, 2, size=(3, 15)),
                             dtype=torch.int32, device=dev)
    y8 = torch.zeros((8,), dtype=torch.int64, device=dev)
    entries.append(EntryPoint(
        "dse._votes_accuracy_paired", "src/repro_torch/core/dse.py",
        lambda: dse._votes_accuracy_paired(bits4, assign, y8, va6, vb6)))

    # -- the trainer's family programs and the solver lanes -----------------
    p, n, dd, f = 2, 32, 3, 2
    rng_t = np.random.default_rng(5)
    x_t = torch.as_tensor(rng_t.normal(size=(p, n, dd)), **f32)
    y_t = torch.as_tensor(np.where(rng_t.random((p, n)) > 0.5, 1.0, -1.0),
                          **f32)
    folds = torch.as_tensor(rng_t.random((p, f, n)) > 0.5, **f32)
    valid = torch.ones((p, n), **f32)
    gammas = torch.tensor([0.5, 1.0], **f32)
    cs = torch.tensor([1.0, 10.0], **f32)
    entries.append(EntryPoint(
        "trainer._cv_grid_all_pairs", _TRAINER,
        lambda: trainer._cv_grid_all_pairs(x_t, y_t, folds, valid, gammas,
                                           cs, "rbf", 3)))
    entries.append(EntryPoint(
        "trainer._refit_all_pairs", _TRAINER,
        lambda: trainer._refit_all_pairs(x_t, y_t, valid, gammas, cs, "rbf",
                                         4)))

    c_box = torch.ones((p, 4, n), **f32)
    gamma_pg = torch.ones((p, 2), **f32)
    entries.append(EntryPoint(
        "ops.solve_lanes", "src/repro_torch/kernels/ops.py",
        lambda: ops.solve_lanes(x_t, y_t, c_box, gamma_pg, kind="rbf",
                                n_epochs=2)))
    return entries

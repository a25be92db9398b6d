"""FleetMachine: many CompiledMachines co-batched into one forward.

The port of ``repro.api.fleet``.  A deployed near-sensor installation is a
*fleet*: many trained machines (datasets, circuit corners, tenants)
answering continuous small-query streams.  ``compile_fleet`` concatenates
member machines into one co-batched machine whose forward

    ``forward(x (n, d_max) f32, model_idx (n,) i32)
        -> (labels (n,) i32, scores (n, P_total) f32)``

serves a batch whose rows belong to any mix of members in one pass:

* **Shared padded input layout** — rows are padded on the feature axis to
  ``d_max = max(member.n_features)``; member ``m``'s banks read only
  ``x[:, :d_m]``.
* **Per-member pair slices** — every member's banks are carried verbatim
  and scored by the member's own ``_all_scores`` on the same tensors, its
  score columns the contiguous slice ``pair_slice(model_id)`` of the
  concatenated ``(n, P_total)`` tensor.  So ``FleetMachine.predict(x,
  model)`` is ``member.predict(x)`` bit for bit (scores, bits, labels), on
  the card as on the CPU: the same operations on the same rows.
* **Routing** — every member's labels are computed for all rows and one
  gather along the member axis picks each row's own member.

A fleet lives on its members' device (they must share one).  Its serving
hot path is the labels-only :meth:`FleetMachine._labels`; the engine
(``repro_torch.serving.svm_engine``) stages rows into pinned slots and runs
it on its own CUDA stream.  :class:`ShardedFleetForward` splits a batch
over a ``launch.mesh.make_serving_mesh`` mesh: the banks are replicated to
each device once and each device runs the same labels program on its whole
slice.  Saves are the reference's one-npz-plus-json fleet format, read and
written alike.
"""
from __future__ import annotations

import json
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api.compiled import (
    DECIDERS,
    CompiledMachine,
    _all_scores,
    _bank_arrays,
    _banks_from_entries,
    _dag_labels,
    _dag_row_maps,
    _dag_step_plans,
    _strip_ext,
    _t,
)
from repro_torch.core.ovo import pair_index_matrix
from repro_torch.device import device_key, resolve_device
from repro_torch.launch.mesh import SERVING_AXIS, require_axis

_FLEET_FORMAT = "repro.api.FleetMachine"
_FLEET_VERSION = 1

ModelRef = Union[str, int]


class FleetMachine:
    """Co-batched multi-model machine (see the module docstring).

    Construct via :func:`compile_fleet` or :meth:`FleetMachine.load`.
    """

    def __init__(self, model_ids: Sequence[str],
                 machines: Sequence[CompiledMachine],
                 decider: str = "votes"):
        if len(model_ids) != len(machines) or not machines:
            raise ValueError("need one model id per member machine (>= 1)")
        if len(set(model_ids)) != len(model_ids):
            raise ValueError(f"duplicate model ids: {list(model_ids)}")
        devices = {device_key(m.device) for m in machines}
        if len(devices) != 1:
            raise ValueError(f"fleet members live on different devices "
                             f"{sorted(map(str, devices))}; move them to one "
                             f"with CompiledMachine.to")
        self.device = machines[0].device
        self.model_ids = [str(m) for m in model_ids]
        self._members = list(machines)
        self._index = {m: i for i, m in enumerate(self.model_ids)}
        self.n_models = len(self._members)
        self.n_features = max(m.n_features for m in self._members)
        self.n_pairs_total = sum(m.n_pairs for m in self._members)
        offs = np.cumsum([0] + [m.n_pairs for m in self._members])
        self._pair_slices = [(int(offs[i]), int(offs[i + 1]))
                             for i in range(self.n_models)]

        # The labels path's decision front: dense votes or each member's
        # O(K) DAG elimination front.  The scores path (`decision_scores`,
        # `predict_bits`) always runs dense, the bit-identity oracle.
        if decider not in DECIDERS:
            raise ValueError(
                f"unknown decider {decider!r}; one of {DECIDERS}")
        self.decider = decider
        if decider == "dag":
            self._pair_matrices = [
                _t(pair_index_matrix(m.n_classes), self.device, torch.int64)
                for m in self._members]
            self._row_maps = [
                _dag_row_maps(m._linear_banks, m._kernel_banks, m.n_pairs)
                for m in self._members]
            self._step_plans = [
                _dag_step_plans(m._linear_banks, m._kernel_banks,
                                m.n_classes)
                for m in self._members]
        # Data-parallel serving legs, one per mesh.
        self._sharded: dict = {}

    # -- introspection -------------------------------------------------------

    def member(self, model: ModelRef) -> CompiledMachine:
        return self._members[self.model_index(model)]

    def model_index(self, model: ModelRef) -> int:
        if isinstance(model, str):
            try:
                return self._index[model]
            except KeyError:
                raise KeyError(
                    f"unknown model id {model!r}; fleet serves "
                    f"{self.model_ids}") from None
        i = int(model)
        if not 0 <= i < self.n_models:
            raise IndexError(f"model index {i} out of range "
                             f"[0, {self.n_models})")
        return i

    def pair_slice(self, model: ModelRef) -> tuple[int, int]:
        """Column slice of this member in the ``(n, P_total)`` tensor."""
        return self._pair_slices[self.model_index(model)]

    def describe(self) -> str:
        parts = [f"FleetMachine({self.n_models} models, "
                 f"P_total={self.n_pairs_total}, d_max={self.n_features}, "
                 f"decider={self.decider}, device={self.device})"]
        for mid, m, (lo, hi) in zip(self.model_ids, self._members,
                                    self._pair_slices):
            parts.append(f"  [{mid}] cols {lo}:{hi} K={m.n_classes} "
                         f"P={m.n_pairs} d={m.n_features}")
        return "\n".join(parts)

    def to(self, device) -> "FleetMachine":
        """This fleet with every member's banks on ``device`` (itself if
        they are there already)."""
        dev = resolve_device(device)
        if device_key(dev) == device_key(self.device):
            return self
        return FleetMachine(self.model_ids,
                            [m.to(dev) for m in self._members],
                            decider=self.decider)

    # -- the co-batched forward ----------------------------------------------

    def _member_input(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Member ``i``'s feature slice of the padded rows, contiguous as
        the member's own ``predict`` receives its input."""
        d = self._members[i].n_features
        return x if d == x.shape[1] else x[:, :d].contiguous()

    def _member_scores(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Member ``i``'s exact forward subgraph on its feature slice."""
        m = self._members[i]
        return _all_scores(self._member_input(i, x), m._linear_banks,
                           m._kernel_banks, m._inv_perm)

    def _member_labels(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Member ``i``'s labels of every row through the fleet's front."""
        m = self._members[i]
        if self.decider == "dag":
            return _dag_labels(self._member_input(i, x), m.n_classes,
                               self._pair_matrices[i], m._linear_banks,
                               m._kernel_banks, self._row_maps[i],
                               self._step_plans[i])
        bits = (self._member_scores(i, x) >= 0.0).to(torch.int32)
        return m._decider(bits)

    @staticmethod
    def _route(labels: list, model_idx: torch.Tensor) -> torch.Tensor:
        lab = torch.stack(labels, dim=0)                         # (M, n)
        return lab.gather(0, model_idx.to(torch.int64)[None, :])[0].to(
            torch.int32)

    def _forward(self, x: torch.Tensor, model_idx: torch.Tensor):
        """x (n, d_max), model_idx (n,) -> (labels (n,) i32 by the dense
        votes, scores (n, P_total))."""
        cols, labels = [], []
        for i, m in enumerate(self._members):
            scores = self._member_scores(i, x)
            labels.append(m._decider((scores >= 0.0).to(torch.int32)))
            cols.append(scores)
        return self._route(labels, model_idx), torch.cat(cols, dim=1)

    def _labels(self, x: torch.Tensor, model_idx: torch.Tensor
                ) -> torch.Tensor:
        """The serving hot path: routed labels (n,) i32 only.

        ``decider="votes"``: the dense per-member decision encoders, no
        score concatenation.  ``"dag"``: each member's K-1-step elimination
        front, O(n*K) pair evaluations per member instead of O(n*K^2).
        """
        return self._route([self._member_labels(i, x)
                            for i in range(self.n_models)], model_idx)

    # -- data-parallel serving leg -------------------------------------------

    def shard(self, mesh) -> "ShardedFleetForward":
        """The sharded labels program for a ``make_serving_mesh`` mesh
        (cached per mesh): each device's whole row slice runs this fleet's
        own ``_labels`` on a replica of the banks, so every slice equals
        the unsharded forward on the same rows."""
        fwd = self._sharded.get(mesh)
        if fwd is None:
            fwd = ShardedFleetForward(self, mesh)
            self._sharded[mesh] = fwd
        return fwd

    # -- host API ------------------------------------------------------------

    def _pad_features(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] > self.n_features:
            raise ValueError(
                f"expected (n, <= {self.n_features}) inputs, got {x.shape}")
        if x.shape[1] < self.n_features:
            x = np.pad(x, ((0, 0), (0, self.n_features - x.shape[1])))
        return x

    def _resolve_idx(self, model, n: int) -> np.ndarray:
        if isinstance(model, (str, int, np.integer)):
            return np.full((n,), self.model_index(model), np.int32)
        idx = np.asarray([self.model_index(m) for m in model], np.int32)
        if idx.shape != (n,):
            raise ValueError(f"{idx.shape[0]} model ids for {n} rows")
        return idx

    def _inputs(self, x: np.ndarray, model):
        x = self._pad_features(x)
        idx = self._resolve_idx(model, x.shape[0])
        return (torch.as_tensor(np.ascontiguousarray(x), device=self.device),
                torch.as_tensor(idx, device=self.device))

    def _run(self, x: np.ndarray, model):
        return self._forward(*self._inputs(x, model))

    def predict(self, x: np.ndarray, model) -> np.ndarray:
        """Routed class labels (n,) via the fleet's decision front.
        ``model`` is one id (str/int) for the whole batch or a per-row
        sequence of ids."""
        return self._labels(*self._inputs(x, model)).cpu().numpy()

    def predict_votes(self, x: np.ndarray, model) -> np.ndarray:
        """Routed labels via the dense votes oracle, whatever the fleet's
        ``decider``."""
        return self._run(x, model)[0].cpu().numpy()

    def decision_scores(self, x: np.ndarray, model: ModelRef) -> np.ndarray:
        """ONE member's raw pair scores (n, P_m) out of the co-batched
        forward: the bit-identity probe against ``member.decision_scores``.
        """
        lo, hi = self.pair_slice(model)
        return self._run(x, model)[1][:, lo:hi].cpu().numpy()

    def predict_bits(self, x: np.ndarray, model: ModelRef) -> np.ndarray:
        """ONE member's comparator bits (n, P_m) from the co-batched pass."""
        return (self.decision_scores(x, model) >= 0.0).astype(np.int32)

    def accuracy(self, x: np.ndarray, y: np.ndarray, model: ModelRef) -> float:
        return float(np.mean(self.predict(x, model) == np.asarray(y)))

    # -- serialization (one npz + json for the whole fleet) ------------------

    def save(self, path: str) -> None:
        """Write ``<path>.npz`` + ``<path>.json`` packing every member."""
        path = _strip_ext(path)
        arrays: dict[str, np.ndarray] = {}
        members = []
        for i, (mid, m) in enumerate(zip(self.model_ids, self._members)):
            arr, meta_banks = _bank_arrays(
                m._linear_banks, m._kernel_banks, prefix=f"m{i}.")
            arrays.update(arr)
            members.append({"model_id": mid, "n_classes": m.n_classes,
                            "kernel_map": m.kernel_map, "banks": meta_banks})
        meta = {"format": _FLEET_FORMAT, "version": _FLEET_VERSION,
                "decider": self.decider, "members": members}
        np.savez(path + ".npz", **arrays)
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=2)

    @classmethod
    def load(cls, path: str, device=None,
             decider: Optional[str] = None) -> "FleetMachine":
        """A fleet from a save of either package, on ``device`` (None: the
        card); ``decider`` overrides the saved one."""
        path = _strip_ext(path)
        with open(path + ".json") as f:
            meta = json.load(f)
        if meta.get("format") != _FLEET_FORMAT:
            raise ValueError(f"{path}.json is not a FleetMachine save")
        if int(meta.get("version", 0)) > _FLEET_VERSION:
            raise ValueError(f"FleetMachine save version {meta['version']}; "
                             f"this build reads up to {_FLEET_VERSION}")
        dev = resolve_device(device)
        with np.load(path + ".npz") as npz:
            arrays = {k: npz[k] for k in npz.files}
        ids, machines = [], []
        for entry in meta["members"]:
            linear_banks, kernel_banks = _banks_from_entries(
                entry["banks"], arrays, dev)
            ids.append(entry["model_id"])
            machines.append(CompiledMachine(
                entry["n_classes"], linear_banks, kernel_banks,
                kernel_map=entry.get("kernel_map"), device=dev))
        return cls(ids, machines,
                   decider=decider or meta.get("decider", "votes"))


class _Launch:
    """One device slice in flight: the events recorded before its input
    copy and after its labels were copied back (both None on the CPU, where
    the slice ran at once)."""

    __slots__ = ("start", "end")

    def __init__(self, start, end):
        self.start, self.end = start, end

    def wait(self) -> None:
        if self.end is not None:
            self.end.synchronize()

    def device_ms(self) -> Optional[float]:
        """Device time from the input copy to the labels' copy back (after
        :meth:`wait`); None on the CPU."""
        if self.start is None:
            return None
        return self.start.elapsed_time(self.end)


def enqueue_labels(fleet: FleetMachine, x: torch.Tensor, idx: torch.Tensor,
                   out: torch.Tensor, stream=None, x_dev=None,
                   idx_dev=None) -> _Launch:
    """Run ``fleet._labels`` on host rows ``x (n, d_max)`` / ``idx (n,)``
    into the host labels ``out (n,)`` i32.

    On a card everything is enqueued on ``stream`` and nothing waits: the
    rows go up with ``non_blocking`` copies (into ``x_dev`` / ``idx_dev``
    when given), the labels come back into ``out`` the same way (pinned
    host tensors make both copies asynchronous), and the returned launch's
    events mark the input copy's start and the labels' arrival (its device
    ms).  On the CPU the labels are computed at once.
    """
    if fleet.device.type != "cuda":
        out.copy_(fleet._labels(x, idx))
        return _Launch(None, None)
    with torch.cuda.device(fleet.device), torch.cuda.stream(stream):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        xd = x.to(fleet.device, non_blocking=True) if x_dev is None \
            else x_dev.copy_(x, non_blocking=True)
        idd = idx.to(fleet.device, non_blocking=True) if idx_dev is None \
            else idx_dev.copy_(idx, non_blocking=True)
        out.copy_(fleet._labels(xd, idd), non_blocking=True)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
    return _Launch(start, end)


def host_buffer(shape, dtype, device) -> torch.Tensor:
    """A host tensor, page-locked when ``device`` is a card (so copies to
    and from it can run asynchronously on a stream)."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.device(device).type == "cuda")


class ShardedFleetForward:
    """Data-parallel fleet labels over a ``make_serving_mesh`` mesh.

    The banks are replicated to each of the mesh's devices once (a device
    already holding them keeps the fleet itself); a batch splits into whole
    per-device row slices, each runs the fleet's own ``_labels`` on its
    device, on that device's stream, and the slices join on the host.
    There is no exchange between devices, so each slice equals the
    unsharded forward on the same rows; at d = 1 this is the unsharded
    program.
    """

    def __init__(self, fleet: FleetMachine, mesh):
        self.n_devices = require_axis(mesh, SERVING_AXIS,
                                      "make_serving_mesh")
        self.fleet = fleet
        self.mesh = mesh
        self.devices = tuple(mesh.devices)
        replicas: dict = {}
        for dev in self.devices:
            key = device_key(dev)
            if key not in replicas:
                replicas[key] = fleet.to(dev)
        self.replicas = [replicas[device_key(d)] for d in self.devices]
        self.streams = []
        for dev in self.devices:
            if dev.type != "cuda":
                self.streams.append(None)
                continue
            stream = torch.cuda.Stream(dev)
            # The replicated banks were written on the default stream.
            stream.wait_stream(torch.cuda.current_stream(dev))
            self.streams.append(stream)

    def global_rows(self, per_device_rows: int) -> int:
        """Whole-slice rounding: the global batch for one device bucket."""
        return int(per_device_rows) * self.n_devices

    def enqueue(self, x: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
                dev_bufs=None) -> list:
        """Enqueue every device's slice of host rows ``x`` / ``idx`` into
        ``out`` (see :func:`enqueue_labels`); ``dev_bufs`` holds one
        ``(x_dev, idx_dev)`` pair per device.  Returns one launch per
        device."""
        n = x.shape[0]
        if n % self.n_devices:
            raise ValueError(
                f"{n} rows not divisible into {self.n_devices} device "
                f"slices; pad to whole per-device slices first")
        per = n // self.n_devices
        launches = []
        for i, (fleet, stream) in enumerate(zip(self.replicas, self.streams)):
            rows = slice(i * per, (i + 1) * per)
            xd, idd = dev_bufs[i] if dev_bufs is not None else (None, None)
            launches.append(enqueue_labels(fleet, x[rows], idx[rows],
                                           out[rows], stream, xd, idd))
        return launches

    def __call__(self, x, model_idx) -> np.ndarray:
        """Blocking sharded labels of host rows (a whole number of
        per-device slices): ``(n,)`` i32."""
        dev = self.devices[0]
        n = np.shape(x)[0]
        xh = host_buffer((n, self.fleet.n_features), torch.float32, dev)
        ih = host_buffer((n,), torch.int32, dev)
        out = host_buffer((n,), torch.int32, dev)
        xh.numpy()[:] = np.asarray(x, np.float32)
        ih.numpy()[:] = np.asarray(model_idx, np.int32)
        for launch in self.enqueue(xh, ih, out):
            launch.wait()
        return out.numpy().copy()

    def predict(self, x: np.ndarray, model) -> np.ndarray:
        """Blocking convenience wrapper: pads the tail to whole per-device
        slices (zeros, model 0; computed and discarded), trims on return."""
        x = self.fleet._pad_features(x)
        idx = self.fleet._resolve_idx(model, x.shape[0])
        n = x.shape[0]
        pad = -n % self.n_devices
        if pad:
            x = np.pad(x, ((0, pad), (0, 0)))
            idx = np.pad(idx, (0, pad))
        return self(x, idx)[:n]


def compile_fleet(
    machines: Union[Mapping[str, CompiledMachine],
                    Sequence[tuple[str, CompiledMachine]],
                    Sequence[CompiledMachine]],
    decider: str = "votes",
) -> FleetMachine:
    """Concatenate compiled machines into one co-batched :class:`FleetMachine`.

    ``machines`` is a ``{model_id: CompiledMachine}`` mapping (insertion
    order fixes the member order), a sequence of ``(model_id, machine)``
    pairs, or a bare sequence of machines (ids default to ``"model<i>"``).
    A single-member fleet is valid: it is how the serving engine wraps a
    lone :class:`CompiledMachine`.  The fleet runs on its members' device.
    """
    if isinstance(machines, Mapping):
        items = list(machines.items())
    else:
        items = []
        for i, it in enumerate(machines):
            if isinstance(it, tuple) and len(it) == 2:
                items.append((str(it[0]), it[1]))
            else:
                items.append((f"model{i}", it))
    ids = [i for i, _ in items]
    members = [m for _, m in items]
    for m in members:
        if not isinstance(m, CompiledMachine):
            raise TypeError(
                f"compile_fleet takes CompiledMachine members, got "
                f"{type(m).__name__}; lower with compile_machine first")
    return FleetMachine(ids, members, decider=decider)

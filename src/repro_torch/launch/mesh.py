"""The port's device meshes: one process driving an ordered list of devices.

The reference's meshes (``jax.make_mesh``) are single-process SPMD over the
local devices: ``shard_map`` runs one program per device and joins the
results, with no process group.  The torch twin of that is one process that
enqueues each device's share on that device's stream and joins on the host,
so a mesh here is named axes over an ordered tuple of ``torch.device`` s in
row-major order (:class:`Mesh`); the code that takes a ``mesh=`` does the
split and the join itself (``api.fleet.ShardedFleetForward``, the streamed
Monte-Carlo's ``stream(mesh=)``, the trainer's ``_cv_grid_sharded``, the LM
train step's mesh leg, ``distributed/``).  ``torch.distributed`` and
``DTensor`` need a process group with one rank per device and cannot put
several ranks on one card, so they are not used.

A device may repeat: ``["cpu"] * 8`` runs the split and join logic on the
CPU, ``[card] * 4`` four shares on one card.  ``n_devices=None`` means
every card (``torch.cuda.device_count()``) and raises without one.  The
SVM consumers (trainer, stream, serving engine) take 1-D meshes over their
own axis and refuse any other (``require_axis``).  The LM's meshes are
multi-axis: ``make_production_mesh`` ((16, 16) ``("data", "model")``, or
(2, 16, 16) with ``"pod"`` first), ``make_test_mesh`` ((2, 4) on the CPU).

This module is also the port's counterpart of ``jax.sharding``:
``PartitionSpec`` (``P``), ``device_put`` and ``Sharded``, the stand-in
for a ``NamedSharding``-ed array (one local shard per mesh position), and
of ``jax.ShapeDtypeStruct`` (``ShapeDtype``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import device_key, resolve_device

#: Mesh axis the batched trainer's CV grid shards over (the flattened
#: OvO-pair x gamma cells; ``core.trainer.PAIRGRID_AXIS``).
PAIRGRID_AXIS = "pairgrid"

#: Mesh axis the streaming Monte-Carlo chunk shards over.
VARIANTS_AXIS = "variants"

#: Mesh axis the serving engine's data-parallel forward shards over.
SERVING_AXIS = "batch"


# ---------------------------------------------------------------------------
# Partition specs and shapes
# ---------------------------------------------------------------------------


def _entry(e):
    """A spec entry: None, an axis name, or a tuple of two or more names
    (a one-name tuple is its name, as ``jax.sharding.PartitionSpec``
    compares them)."""
    if e is None or isinstance(e, str):
        return e
    names = tuple(e)
    if not all(isinstance(n, str) for n in names):
        raise TypeError(f"a partition spec entry is None, an axis name or "
                        f"a tuple of names; got {e!r}")
    if not names:
        return None
    return names[0] if len(names) == 1 else names


class PartitionSpec(tuple):
    """One entry per leading dimension of an array: ``None`` (replicated),
    a mesh axis name, or a tuple of names (the dimension split over their
    product, the first name major).  A tuple, so ``P("model", "data") ==
    ("model", "data")``; dimensions past its length are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __reduce__(self):
        return (type(self), tuple(self))

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """An array's shape and dtype with no storage (``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize


def shape_dtype(x) -> ShapeDtype:
    """``ShapeDtype`` of a tensor, a ``ShapeDtype`` or a ``(shape, dtype)``
    pair (``configs.base.input_specs``' leaves)."""
    if isinstance(x, ShapeDtype):
        return x
    if isinstance(x, (torch.Tensor, Sharded)):
        return ShapeDtype(tuple(x.shape), x.dtype)
    shape, dtype = x
    return ShapeDtype(tuple(shape), dtype)


def is_shape_leaf(x) -> bool:
    """A tensor, a ``Sharded``, a ``ShapeDtype`` or a ``(shape, dtype)``
    pair."""
    return isinstance(x, (torch.Tensor, Sharded, ShapeDtype)) or (
        isinstance(x, tuple) and len(x) == 2
        and isinstance(x[1], torch.dtype))


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over an ordered tuple of devices, row-major: the device at
    position ``(i, j)`` of a ``(2, 4)`` mesh is ``devices[4 * i + j]``.

    ``shape`` is ``{axis: n}`` as on a ``jax.sharding.Mesh``, so code that
    reads ``mesh.shape["variants"]`` reads the same here.  ``axis_sizes``
    defaults to ``(len(devices),)`` for one axis.  Frozen and hashable: a
    fleet caches its sharded forward per mesh."""

    axis_names: tuple
    devices: tuple
    axis_sizes: tuple = None

    def __post_init__(self):
        names = tuple(self.axis_names)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "devices", tuple(self.devices))
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        sizes = self.axis_sizes
        if sizes is None:
            if len(names) != 1:
                raise ValueError(f"a mesh of axes {names} needs axis_sizes")
            sizes = (len(self.devices),)
        sizes = tuple(int(n) for n in sizes)
        object.__setattr__(self, "axis_sizes", sizes)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"axes {names} and sizes {sizes} do not match")
        if math.prod(sizes) != len(self.devices):
            raise ValueError(f"a {sizes} mesh needs {math.prod(sizes)} "
                             f"devices, got {len(self.devices)}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def positions(self):
        """Every mesh position (a tuple of per-axis indices), row-major,
        the order of ``devices``."""
        return itertools.product(*(range(n) for n in self.axis_sizes))

    def device_at(self, position: Sequence[int]) -> torch.device:
        return self.devices[int(np.ravel_multi_index(tuple(position),
                                                     self.axis_sizes))]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, every other axis at index 0."""
        i = self.axis_names.index(axis)
        return [self.device_at([s if j == i else 0
                                for j in range(len(self.axis_names))])
                for s in range(self.axis_sizes[i])]


def _mesh_device(d) -> torch.device:
    dev = torch.device(d)
    return dev if dev.type == "meta" else resolve_device(dev)


def _mesh_devices(n_devices: Optional[int],
                  devices: Optional[Sequence]) -> tuple[torch.device, ...]:
    if devices is not None:
        devs = tuple(_mesh_device(d) for d in devices)
        if n_devices is not None and int(n_devices) != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} devices "
                             f"given")
        return devs
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh defaults to the cards and no CUDA device is available; "
            "pass devices=['cpu'] * n to run the split on the CPU")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"{n} devices asked for, {count} cards present")
    return tuple(torch.device("cuda", i) for i in range(n))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` (``jax.make_mesh``): ``devices``
    in row-major order, by default the first ``prod(shape)`` cards."""
    return Mesh(tuple(axes), _mesh_devices(math.prod(shape), devices),
                tuple(shape))


def _make(axis: str, n_devices, devices) -> Mesh:
    return Mesh((axis,), _mesh_devices(n_devices, devices))


def make_trainer_mesh(n_devices: Optional[int] = None,
                      devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh for the batched trainer's sharded CV grid: the flattened
    OvO-pair x gamma cells split across the ``"pairgrid"`` axis, with no
    exchange between devices."""
    return _make(PAIRGRID_AXIS, n_devices, devices)


def make_variant_mesh(n_devices: Optional[int] = None,
                      devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh for the streaming Monte-Carlo engine: each device draws and
    scores its slice of a variant chunk, the linear aggregates merge on the
    first device, and the running state stays there."""
    return _make(VARIANTS_AXIS, n_devices, devices)


def make_serving_mesh(n_devices: Optional[int] = None,
                      devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh for the fleet serving engine's data-parallel forward: the
    padded dispatch batch splits into whole per-device slices, the banks
    are replicated, and each device runs the fleet's own labels program on
    its slice.  A 1-device mesh is the unsharded program."""
    return _make(SERVING_AXIS, n_devices, devices)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """(16, 16) ``("data", "model")`` over 256 devices, or (2, 16, 16)
    ``("pod", "data", "model")`` over 512.  Without ``devices`` it takes
    the cards and raises unless that many are present; the dry run passes
    ``devices=["meta"] * 256`` (or 512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_test_mesh(shape=(2, 4), axes=("data", "model"),
                   devices: Optional[Sequence] = None) -> Mesh:
    """Small mesh for tests, on the CPU unless ``devices`` says otherwise
    (``["cpu"] * prod(shape)``)."""
    if devices is None:
        devices = ["cpu"] * math.prod(shape)
    return make_mesh(shape, axes, devices)


def dp_axes(multi_pod: bool) -> tuple:
    """The data-parallel axes of a production mesh."""
    return ("pod", "data") if multi_pod else ("data",)


def require_axis(mesh, axis: str, maker: str) -> int:
    """The device count of a 1-D mesh over ``axis``, or a ValueError naming
    ``axis`` and the function that builds such a mesh."""
    names = tuple(getattr(mesh, "axis_names", ()))
    if axis not in names:
        raise ValueError(f"mesh axes {names} lack {axis!r}; build one with "
                         f"launch.mesh.{maker}()")
    if len(names) != 1:
        raise ValueError(f"a 1-D mesh over {axis!r} is needed, got axes "
                         f"{names}; build one with launch.mesh.{maker}()")
    return int(mesh.shape[axis])


# ---------------------------------------------------------------------------
# Sharded arrays
# ---------------------------------------------------------------------------


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_counts(shape: Sequence[int], spec, axis_sizes: dict) -> list[int]:
    """How many pieces each dimension of ``shape`` splits into under
    ``spec`` (1 where it is replicated)."""
    counts = [1] * len(shape)
    for d, entry in enumerate(spec):
        counts[d] = math.prod(axis_sizes[a] for a in _axes(entry))
    return counts


def local_shape(shape: Sequence[int], spec, axis_sizes: dict) -> tuple:
    """The per-device shard shape of an array of ``shape`` under ``spec``."""
    return tuple(n // c for n, c in zip(
        shape, shard_counts(shape, spec, axis_sizes)))


def _check(shape, spec, mesh: Mesh) -> None:
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    used = [a for e in spec for a in _axes(e)]
    for a in used:
        if a not in mesh.shape:
            raise ValueError(f"spec {spec} names {a!r}, not an axis of the "
                             f"mesh {mesh.axis_names}")
    if len(set(used)) != len(used):
        raise ValueError(f"spec {spec} uses an axis twice")
    for d, c in enumerate(shard_counts(shape, spec, mesh.shape)):
        if shape[d] % c:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split into {c} under {spec} (fit_spec drops "
                             "such a sharding)")


def shard_index(shape, spec, mesh: Mesh, position) -> tuple:
    """The slices of the global array that mesh ``position`` holds."""
    where = dict(zip(mesh.axis_names, position))
    out = []
    for d, n in enumerate(shape):
        axes = _axes(spec[d]) if d < len(spec) else ()
        count = math.prod(mesh.shape[a] for a in axes)
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + where[a]
        step = n // count
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


@dataclasses.dataclass(eq=False)
class Sharded:
    """A global array laid out on a mesh by a ``PartitionSpec``: one local
    shard per mesh position (row-major, as ``mesh.devices``), on that
    position's device.  Positions that hold the same slice on the same
    device share one tensor, so a replicated leaf on ``[card] * 4`` is one
    copy on the card; code that updates shards in place walks ``unique()``."""

    mesh: Mesh
    spec: PartitionSpec
    shape: tuple
    dtype: torch.dtype
    shards: tuple

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def local_shape(self) -> tuple:
        return local_shape(self.shape, self.spec, self.mesh.shape)

    def index(self, i: int) -> tuple:
        """The slices of the global array that the ``i``-th mesh position
        (row-major) holds."""
        pos = np.unravel_index(i, self.mesh.axis_sizes)
        return shard_index(self.shape, self.spec, self.mesh,
                           tuple(int(j) for j in pos))

    def unique(self) -> list[tuple[tuple, torch.Tensor]]:
        """``(slices, tensor)`` of each distinct shard tensor, in the order
        of the first position holding it."""
        seen, out = set(), []
        for pos, t in zip(self.mesh.positions(), self.shards):
            if id(t) not in seen:
                seen.add(id(t))
                out.append((shard_index(self.shape, self.spec, self.mesh,
                                        pos), t))
        return out

    def full(self, device=None) -> torch.Tensor:
        """The global array, assembled on ``device`` (default: the mesh's
        first device)."""
        dev = self.mesh.devices[0] if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for idx, t in self.unique():
            out[idx] = t.to(dev)
        return out


def device_put(x, mesh: Mesh, spec=None) -> Sharded:
    """``x`` (a tensor, a numpy array, a number or a ``Sharded``, which is
    gathered first) laid out on ``mesh`` by ``spec`` (default: replicated).
    Raises on a dimension the mesh does not divide."""
    if isinstance(x, Sharded):
        x = x.full()
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    spec = P() if spec is None else P(*spec)
    shape = tuple(x.shape)
    _check(shape, spec, mesh)
    cache: dict = {}
    shards = []
    for pos in mesh.positions():
        dev = mesh.device_at(pos)
        idx = shard_index(shape, spec, mesh, pos)
        key = (str(device_key(dev)),
               tuple((s.start, s.stop) for s in idx))
        if key not in cache:
            cache[key] = x[idx].to(dev, copy=True).contiguous()
        shards.append(cache[key])
    return Sharded(mesh, spec, shape, x.dtype, tuple(shards))

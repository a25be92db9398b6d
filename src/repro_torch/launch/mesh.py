"""The port's device meshes: one process driving an ordered list of devices.

The reference's meshes (``jax.make_mesh``) are single-process SPMD over the
local devices: ``shard_map`` runs one program per device and joins the
results, with no process group.  The torch twin of that is one process that
enqueues each device's share on that device's stream and joins on the host,
so a mesh here is no more than a named axis over an ordered tuple of
``torch.device`` s (:class:`Mesh`); the code that takes a ``mesh=`` does the
split and the join itself (``api.fleet.ShardedFleetForward``, the streamed
Monte-Carlo's ``stream(mesh=)``, the trainer's ``_cv_grid_sharded``).

Every mesh is 1-D.  ``n_devices=None`` means every card
(``torch.cuda.device_count()``) and raises without one; ``devices=`` names
the devices explicitly, and may repeat one (``["cpu"] * 4`` runs the split
and join logic on the CPU, ``[card] * 2`` two shares on one card).  The
LM's production meshes (``make_production_mesh``, ``dp_axes``) serve only
its distributed training and come with it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.device import resolve_device

#: Mesh axis the batched trainer's CV grid shards over (the flattened
#: OvO-pair x gamma cells; ``core.trainer.PAIRGRID_AXIS``).
PAIRGRID_AXIS = "pairgrid"

#: Mesh axis the streaming Monte-Carlo chunk shards over.
VARIANTS_AXIS = "variants"

#: Mesh axis the serving engine's data-parallel forward shards over.
SERVING_AXIS = "batch"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: one axis name over an ordered tuple of devices.

    ``shape`` is ``{axis: n}`` as on a ``jax.sharding.Mesh``, so code that
    reads ``mesh.shape["variants"]`` reads the same here.  Frozen and
    hashable: a fleet caches its sharded forward per mesh.
    """

    axis_names: tuple[str]
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != 1:
            raise ValueError(f"the port's meshes are 1-D; got axes "
                             f"{self.axis_names}")
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def _mesh_devices(n_devices: Optional[int],
                  devices: Optional[Sequence]) -> tuple[torch.device, ...]:
    if devices is not None:
        devs = tuple(resolve_device(d) for d in devices)
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


def make_test_mesh(shape=(1,), axes=("data",),
                   devices: Optional[Sequence] = None) -> Mesh:
    """Small 1-D mesh for tests, on the CPU unless ``devices`` says
    otherwise (e.g. a mesh whose axis a caller must refuse)."""
    if len(shape) != 1 or len(axes) != 1:
        raise ValueError(f"the port's meshes are 1-D; got shape {shape}, "
                         f"axes {axes}")
    if devices is None:
        devices = ["cpu"] * int(shape[0])
    return _make(str(axes[0]), int(shape[0]), devices)


def require_axis(mesh, axis: str, maker: str) -> int:
    """The device count along ``axis``, or a ValueError naming ``axis``
    and the function that builds a mesh with it."""
    names = tuple(getattr(mesh, "axis_names", ()))
    if axis not in names:
        raise ValueError(f"mesh axes {names} lack {axis!r}; build one with "
                         f"launch.mesh.{maker}()")
    return int(mesh.shape[axis])

"""Elastic rescaling: move a checkpoint onto a different mesh topology.

Counterpart of ``repro/distributed/elastic.py``.  Checkpoints store
logically-global arrays (``repro_torch.checkpoint``, in the reference's
layout); rescaling to a new mesh is therefore: rebuild partition specs
against the new mesh axes and ``launch.mesh.device_put`` each leaf with
its new spec.  This covers both shrink and grow without any resharding
maths in user code: the specs are *logical* (dp/tp/fsdp names), so a
(2, 2) -> (4, 1) change only re-derives shard extents.  A ``Sharded``
leaf is gathered first; host ints (a train state's ``step``) stay as they
are.
"""
from __future__ import annotations

import numbers

from repro_torch.distributed.partition import is_spec, tree_map
from repro_torch.launch.mesh import Mesh, device_put


def reshard(tree, specs, mesh: Mesh):
    """``device_put`` every leaf of ``tree`` with its spec in ``specs``
    (a tree of the same structure; a ``Quant8`` moment's spec is a
    ``Quant8`` of two specs, its leaf a ``Quant8`` or a ``(q, hi)``
    pair)."""
    def put(spec, x):
        if isinstance(x, numbers.Number):
            return x
        return device_put(x, mesh, spec)

    return tree_map(put, specs, tree, is_leaf=is_spec)


def rescale_checkpoint(ckpt_tree, specs, new_mesh: Mesh):
    """Checkpoint (host arrays) -> new mesh.  Alias of reshard, named for
    the operational flow (restore -> rescale -> resume)."""
    return reshard(ckpt_tree, specs, new_mesh)

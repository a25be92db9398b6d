"""int8 gradient compression with error feedback, and its all-reduce.

Counterpart of ``repro/distributed/compression.py``.  The data-parallel
gradient all-reduce is the dominant cross-pod collective; compressing it
4x (f32 -> int8 blockwise) cuts its bytes proportionally.  Error feedback
keeps the scheme unbiased over time: the quantization residual of step t
is added back into step t+1's gradient before quantization (Karimireddy et
al., 2019).

``quantize_block`` / ``dequantize_block`` / ``compress_with_feedback`` are
the reference's formulas on tensors (``torch.round`` rounds half to even,
as ``jnp.round`` does).  ``make_compressed_allreduce(mesh, axis)`` is the
tree all-reduce: leaves are ``(n_shards, ...)`` (a tensor, or a
``Sharded`` split over ``axis``), share i on the i-th device along
``axis``.  All shares agree on ONE per-block scale before encoding (the
max of their local block maxima, the reference's ``pmax``): summing int8
codes made under per-share scales is not linear and destroys the mean.
The codes are summed in int32 in the mesh's device order on the first
device, divided by n and dequantized; the mean comes back replicated and
each share keeps its error buffer.  The reference's
``compressed_psum_fn`` runs inside ``shard_map`` with an axis context (its
``pmax`` / ``psum``); one process driving the devices has no such context,
so it has no counterpart here: ``compressed_mean`` takes the shares
themselves.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.partition import tree_map
from repro_torch.launch.mesh import Mesh, P, Sharded, device_put


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)


def _step(amax: torch.Tensor, floor: float) -> torch.Tensor:
    """``max(amax, floor) / 127``, divided elementwise: a CUDA division by a
    Python number multiplies by its reciprocal, which can miss the CPU's
    (and the reference's) quotient by an ulp."""
    amax = torch.clamp(amax, min=floor)
    return amax / torch.full_like(amax, 127.0)


def _encode(flat: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)


def quantize_block(x: torch.Tensor, block: int = 256):
    """f32 -> (int8 blocks, f32 scales). Returns padded block view."""
    flat = _blocks(x, block)
    scale = _step(flat.abs().amax(1, keepdim=True), 1e-12)
    return _encode(flat, scale), scale


def dequantize_block(q: torch.Tensor, scale: torch.Tensor, shape
                     ) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compress_with_feedback(grad: torch.Tensor, err: torch.Tensor,
                           block: int = 256):
    """Quantize (grad + err); return (q, scale, new_err)."""
    g = grad.float() + err
    q, scale = quantize_block(g, block)
    return q, scale, g - dequantize_block(q, scale, g.shape)


def common_scale(grads: list[torch.Tensor], errs: list[torch.Tensor],
                 block: int = 256) -> torch.Tensor:
    """The shares' one scale per block, ``max(max_i |grad_i + err_i|,
    1e-12) / 127`` (the reference's ``pmax`` of the local block maxima), on
    the first share's device."""
    head = grads[0].device
    gmax = None
    for g, e in zip(grads, errs, strict=True):
        local = _blocks(g.float() + e, block).abs().amax(1, keepdim=True)
        local = local.to(head)
        gmax = local if gmax is None else torch.maximum(gmax, local)
    return _step(gmax, 1e-12)


def encode_shares(grads: list[torch.Tensor], errs: list[torch.Tensor],
                  block: int = 256):
    """Each share's ``grad + err`` encoded under the shares' common block
    scale -> ``(codes, scale, new_errs)``: ``codes[i]`` int8 ``(n_blocks,
    block)`` on share i's device, ``scale`` f32 ``(n_blocks, 1)`` on the
    first share's, ``new_errs[i]`` the residual on share i's device.  One
    share's temporaries are alive at a time."""
    scale = common_scale(grads, errs, block)
    codes, new_errs = [], []
    for g, e in zip(grads, errs):
        g = g.float() + e
        s = scale.to(g.device)
        q = _encode(_blocks(g, block), s)
        codes.append(q)
        new_errs.append(g - dequantize_block(q, s, g.shape))
    return codes, scale, new_errs


def compressed_mean(grads: list[torch.Tensor], errs: list[torch.Tensor],
                    block: int = 256):
    """The shares' compressed mean -> ``(mean, new_errs)``: codes under one
    scale summed in int32 in share order on the first share's device,
    divided by the share count, dequantized, in the gradients' dtype."""
    codes, scale, new_errs = encode_shares(grads, errs, block)
    head = scale.device
    qsum = None
    for q in codes:
        q = q.to(head).to(torch.int32)
        qsum = q if qsum is None else qsum + q
    n = torch.tensor(float(len(codes)), device=head)
    mean = dequantize_block(qsum.float() / n, scale, grads[0].shape)
    return mean.to(grads[0].dtype), new_errs


def make_compressed_allreduce(mesh: Mesh, axis: str = "data",
                              block: int = 256):
    """Tree all-reduce: ``(grads, errs) -> (mean grads, errs)``.

    Per-share gradients carry an explicit leading share dim: leaves are
    ``(n_shards, ...)`` split over ``axis`` (each dp share computed grads
    on its own microbatch).  Outputs: the mean grads replicated
    (``Sharded``, spec ``P()``), the error-feedback buffers still per
    share (``Sharded``, spec ``P(axis)``)."""
    devs = mesh.axis_devices(axis)
    n = len(devs)

    def shares(x) -> list[torch.Tensor]:
        if isinstance(x, Sharded):
            return [t.to(d) for t, d in zip(_sharded_rows(x, axis, n), devs)]
        if x.shape[0] != n:
            raise ValueError(f"a leaf of {x.shape[0]} shares on a {n}-way "
                             f"{axis!r} axis")
        return [x[i].to(d) for i, d in enumerate(devs)]

    i_axis = mesh.axis_names.index(axis)

    def one(g, e):
        mean, new_errs = compressed_mean(shares(g), shares(e), block)
        rows = [t[None] for t in new_errs]
        err = Sharded(mesh, P(axis), (n,) + tuple(mean.shape),
                      new_errs[0].dtype,
                      tuple(rows[pos[i_axis]].to(dev) for pos, dev in
                            zip(mesh.positions(), mesh.devices)))
        return device_put(mean, mesh), err

    def tree_fn(grads, errs):
        out = tree_map(one, grads, errs)
        is_pair = lambda x: isinstance(x, tuple) and len(x) == 2 and \
            isinstance(x[0], Sharded)
        return (tree_map(lambda o: o[0], out, is_leaf=is_pair),
                tree_map(lambda o: o[1], out, is_leaf=is_pair))

    return tree_fn


def _sharded_rows(x: Sharded, axis: str, n: int) -> list[torch.Tensor]:
    """Share i's ``(...)`` row of a ``Sharded`` split over ``axis``."""
    if x.shape[0] != n:
        raise ValueError(f"a leaf of {x.shape[0]} shares on a {n}-way "
                         f"{axis!r} axis")
    rows = [None] * n
    for i, t in enumerate(x.shards):
        idx = x.index(i)[0]
        for r in range(idx.start, idx.stop):
            if rows[r] is None:
                rows[r] = t[r - idx.start]
    return rows

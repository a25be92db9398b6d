"""K4-bwd: the gradient of K4, the chunked SSD scan, in x, a, B and C,
hand-written in CUDA C++ for Hopper (``csrc/ssd_bwd.cu``).

Replaces no TPU kernel: the reference trains through its jnp
``ssd_chunked`` (``repro/models/ssm.py``) and wraps no Pallas kernel in a
``custom_vjp``.  The port's training path runs K4 on the card, and a
kernel launched through ``ctypes`` has no gradient of its own, so
``ops.SSDScan`` calls this from its backward.

K4's inputs in the model's layout (``x (b, s, nh, dh)``, ``a (b, s, nh)``,
``bmat, cmat (b, s, g, ds)``), the forward's scratch (each chunk's
``cum (b, nh, s)`` and entering state ``s_prev (b, nh, nc, dh, ds)``, as
``ssd.ssd_passes_cuda`` returns them), its final state, ``dy`` like ``x``
and the final state's gradient (or ``None``: zero) -> ``(dx, da, dbmat,
dcmat)``, all f32, at K4's head dims, state widths and chunks.

What bounds it on the card: the f32 operations of the causal (t, j)
pairs, 3 ds + 2 dh multiply-adds each, beside 4 L dh ds per chunk and
head for the state terms (``chip_smoke.ssd_bwd_ops``); its traffic is
a few times K4's.  Four device launches per call, the forward's three
passes in reverse and a sum over each group's heads, no atomics, so two
calls on the same inputs agree bit for bit: every (batch, chunk, head)
tile's own part of the state gradient, the reverse state pass across
chunks, every tile's dx, da and per-head dB / dC in 32 x 32 blocks of
(t, j), then dB and dC summed over the group's heads in head order.  The
wrapper allocates the scratch (the state gradients, the per-head dB and
dC, the dcum terms) with ``torch.empty``.

Beside it: the plain twin ``ref.ssd_scan_bwd``, the plain twins of the
four passes (``ref.ssd_bwd_chunk_states``, ``ref.ssd_bwd_state_pass``,
``ref.ssd_bwd_chunk``, ``ref.ssd_bwd_group_sum``) and the launch counter
``LAUNCHES`` (one per call).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd import ALIGN, HEAD_DIMS, MAX_STATE

#: Device launches per call: chunk states, state pass, chunk, group sum.
DEVICE_LAUNCHES = 4

#: ``fault`` codes of the C entry point, planted only by the checks that
#: must catch them: in the third pass every 32-row j block skips its last
#: t block (the last j block its diagonal one).
FAULT_DROP_LAST_T_BLOCK = 1

LAUNCHES = build.LaunchCounter("ssd_bwd")


def ssd_bwd_passes_cuda(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                        cmat: torch.Tensor, cum: torch.Tensor,
                        s_prev: torch.Tensor, s_fin: torch.Tensor,
                        dy: torch.Tensor, dfinal: torch.Tensor | None = None,
                        chunk: int = 128, chunk_states_only: bool = False,
                        fault: int = 0) -> tuple[torch.Tensor, ...]:
    """Launch K4-bwd's passes on the current stream -> ``(dx, da, dbmat,
    dcmat, dstates (b, nh, nc, dh, ds), dbh, dch (b, s, nh, ds), dcum (b,
    nh, s))``: the gradients and the scratch.  ``dstates`` holds the
    gradient into each chunk's leaving state, ``dbh`` / ``dch`` the
    per-head dB / dC and ``dcum`` the first pass's terms.  With
    ``chunk_states_only`` it stops after pass 1: ``dstates`` holds each
    chunk's own U, ``dch`` the entering states' part of dC, and the
    gradients are uninitialized."""
    b, s, nh, dh = x.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    if dh not in HEAD_DIMS:
        raise ValueError(f"ssm head dim {dh} not in {HEAD_DIMS}")
    if g <= 0 or nh % g or not 0 < ds <= MAX_STATE:
        raise ValueError(f"bad groups / state: nh={nh}, g={g}, ds={ds}")
    if chunk % 32 or not 0 < chunk <= 128 or s % chunk:
        raise ValueError(f"chunk {chunk} must be a multiple of 32 up to 128 "
                         f"dividing s = {s} (pad upstream)")
    nc = s // chunk
    f32 = torch.float32
    state = (b, nh, dh, ds)
    for name, t, shape in (("x", x, (b, s, nh, dh)), ("a", a, (b, s, nh)),
                           ("bmat", bmat, (b, s, g, ds)),
                           ("cmat", cmat, (b, s, g, ds)),
                           ("cum", cum, (b, nh, s)),
                           ("s_prev", s_prev, (b, nh, nc, dh, ds)),
                           ("s_fin", s_fin, state), ("dy", dy, x.shape)):
        build.check_tensor(t, name, tuple(shape), f32)
    if dfinal is not None:
        build.check_tensor(dfinal, "dfinal", state, f32)
    if any(t.device != x.device for t in (a, bmat, cmat, cum, s_prev, s_fin,
                                          dy, dfinal) if t is not None):
        raise ValueError("the backward's inputs must be on one device")
    for name, t in (("x", x), ("dy", dy)):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name} must be {ALIGN}-byte aligned (a fresh "
                             "tensor or a .clone() is)")
    dev = x.device
    dx, da = torch.empty_like(x), torch.empty_like(a)
    dbmat, dcmat = torch.empty_like(bmat), torch.empty_like(cmat)
    dstates = torch.empty_like(s_prev)
    dbh = torch.empty((b, s, nh, ds), dtype=f32, device=dev)
    dch = torch.empty_like(dbh)
    dcum = torch.empty_like(cum)
    lib = build.library("ssd_bwd")
    rc = build.launch(
        lib.k4b_ssd_scan_bwd, dev, x.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), dy.data_ptr(), cum.data_ptr(), s_prev.data_ptr(),
        s_fin.data_ptr(), 0 if dfinal is None else dfinal.data_ptr(),
        dx.data_ptr(), da.data_ptr(), dbmat.data_ptr(), dcmat.data_ptr(),
        dstates.data_ptr(), dbh.data_ptr(), dch.data_ptr(), dcum.data_ptr(),
        b, s, nh, g, dh, ds, chunk, int(chunk_states_only), int(fault))
    build.check(lib, "k4b", rc)
    LAUNCHES.launched((b, s, nh, g, dh, ds, chunk, int(chunk_states_only)))
    return dx, da, dbmat, dcmat, dstates, dbh, dch, dcum


def ssd_scan_bwd_cuda(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                      cmat: torch.Tensor, cum: torch.Tensor,
                      s_prev: torch.Tensor, s_fin: torch.Tensor,
                      dy: torch.Tensor, dfinal: torch.Tensor | None = None,
                      chunk: int = 128, fault: int = 0
                      ) -> tuple[torch.Tensor, ...]:
    """Launch K4-bwd on the current stream -> ``(dx, da, dbmat, dcmat)``."""
    return ssd_bwd_passes_cuda(x, a, bmat, cmat, cum, s_prev, s_fin, dy,
                               dfinal, chunk, fault=fault)[:4]

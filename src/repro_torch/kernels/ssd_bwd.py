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

What bounds it on the card: its products, which run on the tensor cores
in split TF32 (three TF32 products each, at near f32 accuracy; not
PyTorch's TF32 switch): per chunk 2 dh multiply-adds per causal (t, j)
pair and head, 3 ds per pair and group, beside 4 L dh ds per chunk and
head for the state terms (``chip_smoke.ssd_bwd_ops``).  Five device
launches per call, no atomics, so two calls on the same inputs agree bit
for bit: each chunk's own part of the state gradient, the reverse state
pass across chunks, the intra-chunk terms, the leaving state's terms with
da, and the slices' partial dB / dC summed.  The per-tile passes run one
CTA per (batch, chunk, slice of a group's heads: ``ref.ssd_bwd_slices``),
so dB and dC are summed over a slice's heads on chip and the scratch holds
one partial per slice, not per head.  The wrapper allocates the scratch
(the state gradients, the slices' partial dB / dC, the dcum terms) with
``torch.empty``.

Beside it: the plain twin ``ref.ssd_scan_bwd``, the plain twins of the
five passes (``ref.ssd_bwd_chunk_states``, ``ref.ssd_bwd_state_pass``,
``ref.ssd_bwd_chunk``, ``ref.ssd_bwd_state_terms``,
``ref.ssd_bwd_slice_sum``) and the launch counter ``LAUNCHES`` (one per
call).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_bwd_slices
from repro_torch.kernels.ssd import ALIGN, HEAD_DIMS, MAX_STATE
from repro_torch.tracing import LaunchCounter

#: Device launches per call: chunk states, state pass, chunk, state terms,
#: slice sum.
DEVICE_LAUNCHES = 5

#: ``fault`` codes of the C entry point, planted only by the checks that
#: must catch them: in the third pass every 16-row j tile skips its last
#: t tile (the last j tile its diagonal one).
FAULT_DROP_LAST_T_BLOCK = 1

LAUNCHES = LaunchCounter("ssd_bwd")


def ssd_bwd_passes_cuda(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                        cmat: torch.Tensor, cum: torch.Tensor,
                        s_prev: torch.Tensor, s_fin: torch.Tensor,
                        dy: torch.Tensor, dfinal: torch.Tensor | None = None,
                        chunk: int = 128, passes: int = DEVICE_LAUNCHES,
                        fault: int = 0) -> tuple[torch.Tensor, ...]:
    """Launch K4-bwd's first ``passes`` passes on the current stream ->
    ``(dx, da, dbmat, dcmat, dstates (b, nh, nc, dh, ds), dcum (b, nh, s),
    dbp, dcp (b, s, g, slices, ds))``: the gradients and the scratch.
    ``dstates`` holds each chunk's own U after pass 1, then the gradient
    into its leaving state; ``dcum`` the dcum terms so far, ``dbp`` /
    ``dcp`` the slices' partial dB / dC so far.  Outputs no pass has
    written yet are uninitialized."""
    b, s, nh, dh = x.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    if dh not in HEAD_DIMS:
        raise ValueError(f"ssm head dim {dh} not in {HEAD_DIMS}")
    if g <= 0 or nh % g or not 0 < ds <= MAX_STATE:
        raise ValueError(f"bad groups / state: nh={nh}, g={g}, ds={ds}")
    if chunk % 32 or not 0 < chunk <= 128 or s % chunk:
        raise ValueError(f"chunk {chunk} must be a multiple of 32 up to 128 "
                         f"dividing s = {s} (pad upstream)")
    if not 0 < passes <= DEVICE_LAUNCHES:
        raise ValueError(f"passes {passes} not in 1..{DEVICE_LAUNCHES}")
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
    dcum = torch.empty_like(cum)
    dbp = torch.empty((b, s, g, ssd_bwd_slices(nh // g)[1], ds), dtype=f32,
                      device=dev)
    dcp = torch.empty_like(dbp)
    stop = 0 if passes == DEVICE_LAUNCHES else passes
    lib = build.library("ssd_bwd")
    rc = build.launch(
        lib.k4b_ssd_scan_bwd, dev, x.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), dy.data_ptr(), cum.data_ptr(), s_prev.data_ptr(),
        s_fin.data_ptr(), 0 if dfinal is None else dfinal.data_ptr(),
        dx.data_ptr(), da.data_ptr(), dbmat.data_ptr(), dcmat.data_ptr(),
        dstates.data_ptr(), dbp.data_ptr(), dcp.data_ptr(), dcum.data_ptr(),
        b, s, nh, g, dh, ds, chunk, stop, int(fault))
    build.check(lib, "k4b", rc)
    LAUNCHES.launched((b, s, nh, g, dh, ds, chunk, stop))
    return dx, da, dbmat, dcmat, dstates, dcum, dbp, dcp


def scratch_bytes(b: int, s: int, nh: int, g: int, dh: int, ds: int,
                  chunk: int = 128) -> int:
    """Bytes of the scratch a call allocates: the state gradients, the
    dcum terms and the slices' partial dB and dC."""
    slices = ssd_bwd_slices(nh // g)[1]
    return 4 * (b * nh * (s // chunk) * dh * ds + b * nh * s
                + 2 * b * s * g * slices * ds)


def ssd_scan_bwd_cuda(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                      cmat: torch.Tensor, cum: torch.Tensor,
                      s_prev: torch.Tensor, s_fin: torch.Tensor,
                      dy: torch.Tensor, dfinal: torch.Tensor | None = None,
                      chunk: int = 128, fault: int = 0
                      ) -> tuple[torch.Tensor, ...]:
    """Launch K4-bwd on the current stream -> ``(dx, da, dbmat, dcmat)``."""
    return ssd_bwd_passes_cuda(x, a, bmat, cmat, cum, s_prev, s_fin, dy,
                               dfinal, chunk, fault=fault)[:4]

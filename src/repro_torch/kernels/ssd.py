"""K4: the chunked Mamba2 SSD scan with carried state, hand-written in CUDA
C++ for Hopper (``csrc/ssd.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ssd.py::ssd_scan_pallas``
(body ``_ssd_kernel``).  Unlike it, the kernel reads the model's layout
directly: ``x (b, s, nh, dh)``, ``a (b, s, nh)``, ``bmat, cmat (b, s, g,
ds)`` with head h reading group ``h // (nh // g)``, and writes ``y (b, s,
nh, dh)`` and the final state ``(b, nh, dh, ds)``, all f32, so no
transpose or group repeat surrounds the call.  ``s`` must be a multiple of
``chunk`` (a multiple of 32 up to 128); ``models/ssm.ssd_chunked`` pads
with zeros upstream.  The scan starts from the zero state, as the Pallas
kernel's does.

What bounds it on the card: the f32 operations of the two (L, L) products
per chunk (about 1.8 MFLOP per chunk and head, causal half) against ~0.1
MB of traffic.  One call is three device launches: every (batch, chunk,
head) tile's cumsum and own state contribution, then the short state
recurrence across chunks, then every tile's output; the wrapper allocates
their scratch (each chunk's cumsum and state) with ``torch.empty``.

Beside it: the plain version ``ref.ssd_scan``, the plain twins of the three
passes (``ref.ssd_chunk_states``, ``ref.ssd_state_pass``,
``ref.ssd_chunk_scan``) and the launch counter ``LAUNCHES`` (one per call).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.tracing import LaunchCounter

#: hymba's and mamba2's ssm head dim, and the reference's Pallas test
#: sweep's.
HEAD_DIMS = (16, 64)

#: The widest state the kernel takes (mamba2-2.7b's ssm_state); narrower
#: ones are padded to 8, 16, 32, 64 or 128 columns inside it.
MAX_STATE = 128

#: Device launches per call: chunk states, state pass, chunk scan.
DEVICE_LAUNCHES = 3

#: x and y are read and written 16 bytes at a time.
ALIGN = 16

LAUNCHES = LaunchCounter("ssd")


def ssd_passes_cuda(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                    cmat: torch.Tensor, chunk: int = 128,
                    chunk_states_only: bool = False
                    ) -> tuple[torch.Tensor, ...]:
    """Launch K4's three passes on the current stream -> ``(y,
    final_state, cum (b, nh, s), states (b, nh, s // chunk, dh, ds))``,
    ``states`` holding the state entering each chunk.  With
    ``chunk_states_only`` it stops after pass 1, so that ``states`` still
    holds each chunk's own contribution dS (pass 2 rewrites it in place);
    ``y`` and ``final_state`` are then uninitialized."""
    b, s, nh, dh = x.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    if dh not in HEAD_DIMS:
        raise ValueError(f"ssm head dim {dh} not in {HEAD_DIMS}")
    if g <= 0 or nh % g or not 0 < ds <= MAX_STATE:
        raise ValueError(f"bad groups / state: nh={nh}, g={g}, ds={ds}")
    if chunk % 32 or not 0 < chunk <= 128 or s % chunk:
        raise ValueError(f"chunk {chunk} must be a multiple of 32 up to 128 "
                         f"dividing s = {s} (pad upstream)")
    f32 = torch.float32
    build.check_tensor(x, "x", (b, s, nh, dh), f32)
    build.check_tensor(a, "a", (b, s, nh), f32)
    build.check_tensor(bmat, "bmat", (b, s, g, ds), f32)
    build.check_tensor(cmat, "cmat", (b, s, g, ds), f32)
    dev = x.device
    if a.device != dev or bmat.device != dev or cmat.device != dev:
        raise ValueError("x, a, bmat and cmat must be on one device")
    if x.data_ptr() % ALIGN:
        raise ValueError(f"x must be {ALIGN}-byte aligned (a fresh tensor "
                         "or a .clone() is)")
    y = torch.empty_like(x)
    s_fin = torch.empty((b, nh, dh, ds), dtype=f32, device=dev)
    cum = torch.empty((b, nh, s), dtype=f32, device=dev)
    states = torch.empty((b, nh, s // chunk, dh, ds), dtype=f32, device=dev)
    lib = build.library("ssd")
    rc = build.launch(
        lib.k4_ssd_scan, dev, x.data_ptr(), a.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), y.data_ptr(), s_fin.data_ptr(), cum.data_ptr(),
        states.data_ptr(), b, s, nh, g, dh, ds, chunk,
        int(chunk_states_only))
    build.check(lib, "k4", rc)
    LAUNCHES.launched((b, s, nh, g, dh, ds, chunk, int(chunk_states_only)))
    return y, s_fin, cum, states


def ssd_scan_cuda(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                  cmat: torch.Tensor, chunk: int = 128
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 on the current stream -> ``(y, final_state)``."""
    y, s_fin, _, _ = ssd_passes_cuda(x, a, bmat, cmat, chunk)
    return y, s_fin

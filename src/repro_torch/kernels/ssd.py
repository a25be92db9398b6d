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
MB of traffic.  One block per (batch, head) walks its chunks in order with
the state in shared memory.

Beside it: the plain version ``ref.ssd_scan`` and the launch counter
``LAUNCHES``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: hymba's ssm head dim, and the reference's Pallas test sweep's.
HEAD_DIMS = (16, 64)

LAUNCHES = build.LaunchCounter("ssd")


def ssd_scan_cuda(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                  cmat: torch.Tensor, chunk: int = 128
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 on the current stream -> ``(y, final_state)``."""
    b, s, nh, dh = x.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    if dh not in HEAD_DIMS:
        raise ValueError(f"ssm head dim {dh} not in {HEAD_DIMS}")
    if g <= 0 or nh % g or not 0 < ds <= 64:
        raise ValueError(f"bad groups / state: nh={nh}, g={g}, ds={ds}")
    if chunk % 32 or not 0 < chunk <= 128 or s % chunk:
        raise ValueError(f"chunk {chunk} must be a multiple of 32 up to 128 "
                         f"dividing s = {s} (pad upstream)")
    f32 = torch.float32
    build.check_tensor(x, "x", (b, s, nh, dh), f32)
    build.check_tensor(a, "a", (b, s, nh), f32)
    build.check_tensor(bmat, "bmat", (b, s, g, ds), f32)
    build.check_tensor(cmat, "cmat", (b, s, g, ds), f32)
    if any(t.device != x.device for t in (a, bmat, cmat)):
        raise ValueError("x, a, bmat and cmat must be on one device")
    y = torch.empty_like(x)
    s_fin = torch.empty((b, nh, dh, ds), dtype=f32, device=x.device)
    lib = build.library("ssd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.k4_ssd_scan(
            x.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            y.data_ptr(), s_fin.data_ptr(), b, s, nh, g, dh, ds, chunk,
            stream)
    build.check(lib, "k4", rc)
    LAUNCHES.count += 1
    return y, s_fin

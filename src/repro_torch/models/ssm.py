"""Mamba2 (SSD) block -- projections, depthwise causal conv, chunked scan.

Counterpart of ``repro/models/ssm.py``.  The full-sequence mixer
(``apply_seq``) runs the chunked SSD scan through ``ops.ssd_scan`` (K4 on
the card, its plain chunked version on the CPU); serving decodes with the
O(1) recurrent step (``apply_step``, plain torch; the reference has no
kernel for it).

Precision follows the reference: the depthwise conv multiplies the
activation-dtype ``xbc`` by the f32 ``conv_w`` and so runs in f32; the scan
inputs are f32; the gated output is cast back to the activation dtype
before the norm.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import tracing
from repro_torch.kernels import ops
from repro_torch.models.common import (
    Dense, ModelConfig, dense_apply, dense_init, normal, rmsnorm,
)

#: The SSD scan's chunk on the serve path (the reference's default).
SSD_CHUNK = 128


class SSM(nn.Module):
    """Mamba2 mixer parameters.  ``in_proj`` is fused:
    [z (di), x (di), B (g*ds), C (g*ds), dt (nh)].  The small vectors and
    the conv kernel stay f32, as the reference keeps them."""

    def __init__(self, cfg: ModelConfig, in_proj: Dense, out_proj: Dense,
                 device=None):
        super().__init__()
        nh = cfg.n_ssm_heads
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        f32 = dict(dtype=torch.float32, device=device)

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        self.in_proj, self.out_proj = in_proj, out_proj
        self.conv_w = param(torch.zeros(cfg.conv_width, conv_dim, **f32))
        self.conv_b = param(torch.zeros(conv_dim, **f32))
        self.a_log = param(torch.log(torch.linspace(1.0, 16.0, nh, **f32)))
        self.dt_bias = param(torch.zeros(nh, **f32))
        self.d_skip = param(torch.ones(nh, **f32))
        self.norm = param(torch.ones(cfg.d_inner, **f32))


def init(cfg: ModelConfig, generator: torch.Generator,
         dtype=torch.float32) -> SSM:
    d, di = cfg.d_model, cfg.d_inner
    g, ds, nh = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    p = SSM(cfg,
            dense_init(generator, d, 2 * di + 2 * g * ds + nh, dtype=dtype),
            dense_init(generator, di, d,
                       scale=0.02 / (2 * cfg.n_layers) ** 0.5, dtype=dtype),
            device=generator.device)
    p.conv_w.data = normal(p.conv_w.shape, 0.2, generator, torch.float32)
    return p


class SSMState(NamedTuple):
    """Recurrent state for decode: ssm (b, nh, dh, ds), conv (b, w-1, conv_dim)."""
    ssm: torch.Tensor
    conv: torch.Tensor


def _split(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, g, ds, nh = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * g * ds]
    dt = zxbcdt[..., -nh:]
    return z, xbc, dt


def _conv_causal(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over (b, s, c) with kernel (k, c), in f32."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc.float(), (0, 0, k - 1, 0))
    out = pad[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu(out + b)


def ssd_chunked(x, a, bmat, cmat, chunk: int = SSD_CHUNK):
    """Chunked SSD (K4 through ``ops.ssd_scan``).

    x: (b, s, nh, dh), a: (b, s, nh), bmat/cmat: (b, s, g, ds), all f32.
    ``s`` is padded with zeros to a multiple of ``chunk`` (a = 0 decays by
    1, x = 0 adds nothing, so the final state is unchanged).
    Returns (y (b, s, nh, dh), final_state (b, nh, dh, ds)).
    """
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    y, final = ops.ssd_scan(x.contiguous(), a.contiguous(),
                            bmat.contiguous(), cmat.contiguous(), chunk=chunk)
    return y[:, :s], final


def apply_seq(cfg: ModelConfig, p: SSM, x: torch.Tensor):
    """Full-sequence Mamba2 mixer from the zero state (the reference's
    ``init_state`` has no caller). x: (b, s, d) -> (y, SSMState).

    While the profiler records, the mixer is the span ``ssm.mixer``: in
    training under remat each layer marks it twice, in the forward and in
    the backward's recompute."""
    with tracing.span("ssm.mixer"):
        return _apply_seq(cfg, p, x)


def _apply_seq(cfg: ModelConfig, p: SSM, x: torch.Tensor):
    b, s, _ = x.shape
    nh, dh, ds, g = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    di = cfg.d_inner
    z, xbc, dt = _split(cfg, dense_apply(p.in_proj, x))
    conv_tail = xbc[:, -(cfg.conv_width - 1):, :]            # raw, pre-conv
    xbc = _conv_causal(xbc, p.conv_w, p.conv_b)               # f32
    xs = xbc[..., :di].reshape(b, s, nh, dh)
    bmat = xbc[..., di:di + g * ds].reshape(b, s, g, ds)
    cmat = xbc[..., di + g * ds:].reshape(b, s, g, ds)

    dt = F.softplus(dt.float() + p.dt_bias)                    # (b, s, nh)
    a = -torch.exp(p.a_log) * dt                               # log decay
    xin = xs * dt[..., None]
    y, s_fin = ssd_chunked(xin, a, bmat, cmat)
    y = y + xin * p.d_skip[:, None]                            # D skip
    y = y.reshape(b, s, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p.norm)
    return dense_apply(p.out_proj, y), SSMState(ssm=s_fin,
                                                conv=conv_tail.contiguous())


def apply_step(cfg: ModelConfig, p: SSM, x: torch.Tensor, state: SSMState):
    """O(1) decode step. x: (b, 1, d) -> (y (b, 1, d), new state)."""
    b = x.shape[0]
    nh, dh, ds, g = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    di = cfg.d_inner
    z, xbc, dt = _split(cfg, dense_apply(p.in_proj, x))        # (b, 1, *)
    window = torch.cat([state.conv.to(xbc.dtype), xbc], dim=1)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window.float(), p.conv_w)
                      + p.conv_b)[:, None, :]
    xs = conv_out[..., :di].reshape(b, nh, dh)
    bmat = conv_out[..., di:di + g * ds].reshape(b, g, ds)
    cmat = conv_out[..., di + g * ds:].reshape(b, g, ds)
    rep = nh // g
    bmat = torch.repeat_interleave(bmat, rep, dim=1)           # (b, nh, ds)
    cmat = torch.repeat_interleave(cmat, rep, dim=1)

    dtv = F.softplus(dt[:, 0].float() + p.dt_bias)             # (b, nh)
    decay = torch.exp(-torch.exp(p.a_log) * dtv)               # (b, nh)
    xin = xs * dtv[..., None]
    s_new = decay[..., None, None] * state.ssm + \
        xin[..., None] * bmat[:, :, None, :]
    y = torch.einsum("bhds,bhs->bhd", s_new, cmat) + xin * p.d_skip[:, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p.norm)
    return dense_apply(p.out_proj, y), SSMState(ssm=s_new, conv=window[:, 1:])

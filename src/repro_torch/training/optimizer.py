"""AdamW from scratch (+ optional 8-bit block-quantized moments).

Counterpart of ``repro/training/optimizer.py``, with its formulas kept
exactly: bias corrections ``1 - b**step`` on the new step, ``update =
(m / bc1) / (sqrt(v / bc2) + eps)``, decoupled decay ``lr * wd * p`` on
leaves with ``ndim >= 2`` only, moments in f32 and the parameter cast back
to its dtype.  ``torch.optim.AdamW`` has neither the ``Quant8`` moments nor
that per-leaf decay rule, so the update is written out.

The update is functional over lists of leaves (``apply_updates``), as the
reference's is over its tree, and is also exposed leaf by leaf
(``step_scalars`` + ``update_leaf``) so that the train step can walk the
leaves one at a time and keep one leaf's temporaries alive at once.  The
leaves are the reference's (``models/convert.py`` ``reference_leaves``:
layers stacked, dense weights ``(d_in, d_out)``), so ``ndim``, the 8-bit
blocks and the checkpoint layout are the reference's too.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tracing


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    quantize_state: bool = False     # 8-bit moments
    block: int = 256


_LOG_TINY = -36.0  # log(~2e-16): magnitudes below this quantize to exact 0
_HI_FLOOR = _LOG_TINY + 1e-3  # a block's least ``hi`` (an all-zero block's)


@dataclasses.dataclass
class Quant8:
    """Signed log-domain (dynamic-range) 8-bit code, bitsandbytes-style.

    ``code = sign * round(127 * (log|x| - LOG_TINY) / (hi_b - LOG_TINY))``
    with one f32 ``hi`` per block of ``block`` entries of the flattened
    leaf, padded with zeros to a whole block.  ``q`` is int8 ``(n_blocks,
    block)``, ``hi`` f32 ``(n_blocks, 1)`` and ``shape`` the leaf's shape.
    Log-domain codes bound the multiplicative error of each entry, which
    Adam's second moment needs (linear absmax codes zero its long tail).
    """

    q: torch.Tensor
    hi: torch.Tensor
    shape: tuple

    @classmethod
    def encode(cls, x: torch.Tensor, block: int) -> "Quant8":
        flat = x.reshape(-1)
        pad = (-flat.numel()) % block
        flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
        mag = flat.abs()
        logm = torch.where(mag > 0, torch.log(mag), _LOG_TINY)
        hi = torch.clamp(logm.amax(dim=1, keepdim=True), min=_HI_FLOOR)
        code = torch.round(127.0 * (logm - _LOG_TINY) / (hi - _LOG_TINY))
        code = torch.clamp(code, 0, 127) * torch.sign(flat)
        return cls(q=code.to(torch.int8), hi=hi.float(),
                   shape=tuple(x.shape))

    @classmethod
    def zeros(cls, shape: tuple, block: int, device) -> "Quant8":
        """``encode`` of zeros of ``shape``: every code 0, every block's
        ``hi`` at its floor, with no f32 temporary the size of the leaf."""
        blocks = -(-math.prod(shape) // block)
        return cls(q=torch.zeros((blocks, block), dtype=torch.int8,
                                 device=device),
                   hi=torch.full((blocks, 1), _HI_FLOOR, dtype=torch.float32,
                                 device=device),
                   shape=tuple(shape))

    def decode(self) -> torch.Tensor:
        code = self.q.float()
        mag = torch.exp(_LOG_TINY + code.abs() / 127.0
                        * (self.hi - _LOG_TINY))
        flat = (torch.where(code == 0, 0.0, mag) * torch.sign(code)
                ).reshape(-1)
        return flat[:math.prod(self.shape)].reshape(self.shape)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac, in f32 with the
    reference's order of operations (``step`` an int32 tensor)."""
    f32 = torch.float32
    stepf = step.to(f32)
    warm = cfg.lr * (stepf + 1) / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps).to(f32)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                    * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _zeros_state(cfg: AdamWConfig, p: torch.Tensor):
    if cfg.quantize_state:
        return Quant8.zeros(p.shape, cfg.block, p.device)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_state(cfg: AdamWConfig, params: list[torch.Tensor]) -> dict:
    """Zero moments (f32, or ``Quant8`` with ``quantize_state``) for each
    leaf of ``params``, and ``step`` 0 (an int32 0-d tensor)."""
    dev = params[0].device if params else None
    return {"m": [_zeros_state(cfg, p) for p in params],
            "v": [_zeros_state(cfg, p) for p in params],
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def step_scalars(cfg: AdamWConfig, step: torch.Tensor):
    """The new step (``step + 1``), its learning rate and the two bias
    corrections, as 0-d f32 tensors on ``step``'s device."""
    step = step + 1
    sf = step.to(torch.float32)
    return (step, lr_schedule(cfg, step), 1.0 - torch.pow(cfg.b1, sf),
            1.0 - torch.pow(cfg.b2, sf))


#: Entries of a leaf updated at once.  The update holds a few f32
#: temporaries per entry (~20 bytes); a leaf of a billion entries (an
#: embedding, or 32 stacked MLP weights) updated whole needs ~20 GB beside
#: the state, so leaves are walked in chunks of about this many entries, a
#: whole number of ``Quant8`` blocks, so the codes are the whole leaf's.
UPDATE_CHUNK = 1 << 24


def update_leaf(cfg: AdamWConfig, p: torch.Tensor, g: torch.Tensor, m, v,
                lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
                ndim: int | None = None):
    """One leaf's AdamW step -> ``(new_p, new_m, new_v)``; ``m`` and ``v``
    f32 tensors or ``Quant8`` (re-encoded on the way out), updated
    ``UPDATE_CHUNK`` entries at a time.  The update is elementwise, so a
    shard of a leaf updates alone: ``ndim`` is then the whole leaf's, for
    the decay rule (default ``p.ndim``).  While the profiler records, each
    chunk's ``Quant8`` decode and its encode are spans
    ``optimizer.moments``; f32 moments mark none."""
    decay = cfg.weight_decay if (p.ndim if ndim is None else ndim) >= 2 \
        else 0.0
    quant = isinstance(m, Quant8)
    n = p.numel()
    rows = max(1, UPDATE_CHUNK // cfg.block)     # Quant8 blocks per chunk
    chunk = rows * cfg.block
    new_p = torch.empty(p.shape, dtype=p.dtype, device=p.device)
    flat_p, flat_g, out_p = p.reshape(-1), g.reshape(-1), new_p.view(-1)
    if quant:
        new_m = Quant8(torch.empty_like(m.q), torch.empty_like(m.hi), m.shape)
        new_v = Quant8(torch.empty_like(v.q), torch.empty_like(v.hi), v.shape)
    else:
        new_m = torch.empty(m.shape, dtype=m.dtype, device=m.device)
        new_v = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    for i, s in enumerate(range(0, n, chunk)):
        e = min(n, s + chunk)
        r = slice(i * rows, (i + 1) * rows)
        if quant:
            with tracing.span("optimizer.moments"):
                m_f = Quant8(m.q[r], m.hi[r], (e - s,)).decode()
                v_f = Quant8(v.q[r], v.hi[r], (e - s,)).decode()
        else:
            m_f, v_f = m.reshape(-1)[s:e], v.reshape(-1)[s:e]
        gf = flat_g[s:e].float()
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * gf
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * gf * gf
        update = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
        pf = flat_p[s:e].float()
        out_p[s:e] = pf - lr * (update + decay * pf)
        if quant:
            with tracing.span("optimizer.moments"):
                for src, dst in ((m_f, new_m), (v_f, new_v)):
                    code = Quant8.encode(src, cfg.block)
                    dst.q[r], dst.hi[r] = code.q, code.hi
        else:
            new_m.view(-1)[s:e], new_v.view(-1)[s:e] = m_f, v_f
    return new_p, new_m, new_v


def apply_updates(cfg: AdamWConfig, params: list[torch.Tensor],
                  opt_state: dict, grads: list[torch.Tensor]):
    """One AdamW step over the leaves; returns ``(new_params,
    new_opt_state)`` and changes nothing it is given."""
    step, lr, bc1, bc2 = step_scalars(cfg, opt_state["step"])
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(params, grads, opt_state["m"], opt_state["v"],
                          strict=True):
        np_, nm, nv = update_leaf(cfg, p, g, m, v, lr, bc1, bc2)
        new_p.append(np_)
        new_m.append(nm)
        new_v.append(nv)
    return new_p, {"m": new_m, "v": new_v, "step": step}

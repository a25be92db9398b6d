"""Plain PyTorch reference of the pure state-space family (``ssm``,
Mamba-2, arXiv:2405.21060): the forward pass, the training loss, its
gradients (autograd), AdamW with its moments in the job's format, and the
serve state a prefill packs.

Like ``lm.py`` it imports nothing of the program (no ``repro``,
``repro_torch`` or ``jax``); it takes ``lm.py``'s layers (RMSNorm, the
matrix products and their fp8 control, the Mamba2 mixer and its SSD
recurrence), and runs in f32 with TF32 off (``precision``).  The weights
are drawn from the seed by the published Mamba2 init (``param_specs``),
not by ``lm.py``'s rules: from those (every head's step at softplus(0) =
0.69, conv taps at 0.2) the 64-layer stack's backward is so ill-conditioned
that bf16 gradients lose all agreement with f32 ones (per-leaf relative
error 1.0-1.8 on an H100, against 0.1-0.5 % for f32 kernels), and no
comparison could tell the program from one in fp8.

The model, as the configuration file states it: embedding lookup; per
layer ``x + mamba(rmsnorm(x))``, the mixer of ``lm.py`` (in_proj to z, x,
B, C, dt; causal depthwise conv of width 4 with bias and SiLU; ``dt =
softplus(dt + dt_bias)``, log decay ``-exp(a_log) dt``; the SSD recurrence
from the zero state; the D skip; ``rmsnorm(y * silu(z))``; out_proj); the
final norm, logits ``norm(x) @ unembed^T``; the loss the mean token
cross-entropy plus ``1e-4 * mean(lse^2)``.

Departures from the published model, each the program's too:

* ``embed`` and ``unembed`` are separate tensors where the published model
  ties them: the program trains them as two leaves, and so does this;
* every RMSNorm takes eps 1e-6 (the published model's 1e-5): the
  program's one norm;
* the scan runs in chunks of 128 positions where the published model's
  chunk is 256: the chunk only orders the sums of the same recurrence.

AdamW's moments are f32 (``"moments": "f32"``) or the signed log-domain
8-bit code (``"int8"``), written here from its definition: in blocks of
``moment_block`` entries of the flattened leaf (the last one padded with
zeros), ``hi`` the block's largest ``log|x|``, floored at ``-36 + 1e-3``,
and each entry ``sign(x) round(127 (log|x| + 36) / (hi + 36))``, clamped
to 0..127 in magnitude; a code ``c`` reads back as ``sign(c) exp(-36 +
|c| / 127 (hi + 36))``, and code 0 as exactly 0.  Each step updates from
the moments read back and stores them coded again.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference import lm
from bench.reference.lm import (Z_COEF, adamw_lr, conv_dim, d_inner,
                                layer_view, logits, mamba, precision,
                                rmsnorm, ssm_heads)

#: ``log`` of the least magnitude the 8-bit code keeps; below it an entry
#: codes to 0.
LOG_TINY = -36.0
#: A block's least ``hi`` (that of an all-zero block).
HI_FLOOR = LOG_TINY + 1e-3
#: Entries of a leaf that AdamW updates at once (a whole number of code
#: blocks), so that no temporary is the size of a whole leaf.
UPDATE_CHUNK = 1 << 24


def param_specs(cfg: dict) -> list[tuple[tuple, tuple, tuple]]:
    """``(path, shape, init)`` of every leaf, paths sorted.  ``init`` is one
    of ``lm.param_specs``' or ``("uniform", bound)``, ``("log_uniform", lo,
    hi)`` (the log of a draw uniform in ``[lo, hi]``) or ``("dt_bias",
    dt_min, dt_max, floor)`` (softplus's inverse of a step drawn
    log-uniform in ``[dt_min, dt_max]``, at least ``floor``): the published
    Mamba2 init (``mamba_ssm``: PyTorch's default for the projections and
    the conv, out_proj over ``sqrt(n_layers)``, A in [1, 16], dt in [1e-3,
    1e-1]; embeddings normal at 0.02)."""
    L, d, V = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"]
    di, nh = d_inner(cfg), ssm_heads(cfg)
    g, ds, cw = cfg["ssm_groups"], cfg["ssm_state"], cfg["conv_width"]
    w = ("normal", 0.02)
    one = ("const", 1.0)
    conv = ("uniform", 1 / math.sqrt(cw))
    specs = {
        ("embed",): ((V, d), w),
        ("unembed",): ((V, d), w),
        ("final_norm", "scale"): ((d,), one),
        ("layers", "norm1", "scale"): ((L, d), one),
        ("layers", "ssm", "in_proj", "w"): ((L, d, 2 * di + 2 * g * ds + nh),
                                            ("uniform", 1 / math.sqrt(d))),
        ("layers", "ssm", "out_proj", "w"): ((L, di, d),
                                             ("uniform",
                                              1 / math.sqrt(di * L))),
        ("layers", "ssm", "conv_w"): ((L, cw, conv_dim(cfg)), conv),
        ("layers", "ssm", "conv_b"): ((L, conv_dim(cfg)), conv),
        ("layers", "ssm", "a_log"): ((L, nh), ("log_uniform", 1.0, 16.0)),
        ("layers", "ssm", "dt_bias"): ((L, nh),
                                       ("dt_bias", 1e-3, 1e-1, 1e-4)),
        ("layers", "ssm", "d_skip"): ((L, nh), one),
        ("layers", "ssm", "norm"): ((L, di), one),
    }
    return [(p, *specs[p]) for p in sorted(specs)]


def make_leaf(spec: tuple, seed: int, index: int, device) -> torch.Tensor:
    """One leaf from the seed, f32, drawn on ``device`` in one call
    (``lm.make_leaf`` for its own kinds of init)."""
    _, shape, init = spec
    if init[0] not in ("uniform", "log_uniform", "dt_bias"):
        return lm.make_leaf(spec, seed, index, device)
    gen = torch.Generator(device=device).manual_seed(
        lm.leaf_seed(seed, index))
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    if init[0] == "uniform":
        return u.mul_(2 * init[1]).sub_(init[1])
    if init[0] == "log_uniform":
        return torch.log(u * (init[2] - init[1]) + init[1])
    lo, hi = math.log(init[1]), math.log(init[2])
    dt = torch.exp(u * (hi - lo) + lo).clamp(min=init[3])
    return dt + torch.log(-torch.expm1(-dt))


def make_params(cfg: dict, seed: int, device) -> dict:
    """Every leaf of ``param_specs`` from ``seed``, f32 on ``device``."""
    return {spec[0]: make_leaf(spec, seed, i, device)
            for i, spec in enumerate(param_specs(cfg))}


# ---------------------------------------------------------------------------
# The model and its loss
# ---------------------------------------------------------------------------


def layer(cfg: dict, p: dict, x: torch.Tensor):
    """One layer -> (x, the mixer's final SSD state, its raw conv tail)."""
    y, s_fin, tail = mamba(cfg, p, rmsnorm(x, p["norm1.scale"]))
    return x + y, s_fin, tail


def _checkpointed(cfg: dict, names: list, x: torch.Tensor, *leaves):
    return layer(cfg, dict(zip(names, leaves)), x)[0]


def loss_fn(cfg: dict, params: dict, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """The training loss of one microbatch, each layer recomputed in the
    backward (``checkpoint``) so that the reference fits on the card."""
    x = params[("embed",)][tokens.long()]
    for i in range(cfg["n_layers"]):
        p = layer_view(params, i)
        x = checkpoint(_checkpointed, cfg, list(p), x, *p.values(),
                       use_reentrant=False)
    lf = logits(params, x)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (lse - ll).mean() + Z_COEF * (lse ** 2).mean()


# ---------------------------------------------------------------------------
# The 8-bit moment code
# ---------------------------------------------------------------------------


def encode(x: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` (any shape) -> ``(codes, hi)``: int8 ``(blocks, block)`` and f32
    ``(blocks, 1)``."""
    flat = x.reshape(-1).float()
    flat = F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)
    logm = torch.log(flat.abs()).clamp(min=LOG_TINY)
    hi = logm.amax(dim=1, keepdim=True).clamp(min=HI_FLOOR)
    level = torch.round(127.0 * (logm - LOG_TINY) / (hi - LOG_TINY))
    return (level.clamp(0, 127) * torch.sign(flat)).to(torch.int8), hi


def decode(codes: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` entries that ``encode`` coded, flat, f32."""
    c = codes.float()
    mag = torch.exp(LOG_TINY + c.abs() / 127.0 * (hi - LOG_TINY))
    return (torch.sign(c) * mag).reshape(-1)[:n]


class Moment:
    """One leaf's AdamW moment in the job's format, read and written a
    range of the flattened leaf at a time (a whole number of blocks)."""

    def __init__(self, like: torch.Tensor, fmt: str, block: int):
        if fmt not in ("f32", "int8"):
            raise ValueError(f"unknown moment format {fmt!r}")
        self.n, self.block = like.numel(), block
        if fmt == "f32":
            self.codes = None
            self.value = torch.zeros(self.n, device=like.device)
        else:
            blocks = -(-self.n // block)
            self.codes = torch.zeros((blocks, block), dtype=torch.int8,
                                     device=like.device)
            self.hi = torch.full((blocks, 1), HI_FLOOR, device=like.device)

    def read(self, s: int, e: int) -> torch.Tensor:
        if self.codes is None:
            return self.value[s:e]
        r = slice(s // self.block, -(-e // self.block))
        return decode(self.codes[r], self.hi[r], e - s)

    def write(self, s: int, e: int, x: torch.Tensor) -> None:
        if self.codes is None:
            self.value[s:e] = x
            return
        r = slice(s // self.block, -(-e // self.block))
        self.codes[r], self.hi[r] = encode(x, self.block)

    def norm(self) -> float:
        """The L2 norm of the moment as stored (read back)."""
        total = 0.0
        for s in range(0, self.n, UPDATE_CHUNK):
            total += _sum_sq(self.read(s, min(self.n, s + UPDATE_CHUNK)))
        return math.sqrt(total)


def _sum_sq(x: torch.Tensor) -> float:
    """The sum of ``x``'s squares, in f64 a range of entries at a time
    (an f32 reduction of a billion entries is off by a part in a
    thousand)."""
    flat = x.reshape(-1)
    return sum(float(flat[s:s + UPDATE_CHUNK].double().square().sum())
               for s in range(0, flat.numel(), UPDATE_CHUNK))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def train(cfg: dict, job: dict, params: dict, batches,
          moments: dict | None = None) -> dict:
    """Steps of ``job`` (``grad_accum`` microbatches, the gradient clipped
    to ``clip`` by its global norm, AdamW with ``moments`` in ``"f32"`` or
    ``"int8"``, blocks of ``moment_block``) from ``params``, which are
    updated in place, on ``batches`` of ``(tokens, labels)`` -> ``{"losses":
    each step's mean microbatch loss, "grad_norms": each leaf's norm of the
    first step's clipped gradient as the optimizer got it, its first moment
    as stored over 1 - b1}``.  A ``moments`` dict receives the last step's
    ``"m"`` and ``"v"`` (leaf -> ``Moment``)."""
    b1, b2, eps, wd = job["b1"], job["b2"], job["eps"], job["weight_decay"]
    n = job["grad_accum"]
    fmt, block = job.get("moments", "f32"), job.get("moment_block", 256)
    chunk = max(block, UPDATE_CHUNK // block * block)
    m = {k: Moment(t, fmt, block) for k, t in params.items()}
    v = {k: Moment(t, fmt, block) for k, t in params.items()}
    if moments is not None:
        moments.update(m=m, v=v)
    out = {"losses": [], "grad_norms": {}}
    for step, (tokens, labels) in enumerate(batches, start=1):
        for t in params.values():
            t.requires_grad_(True)
        total = 0.0
        for mt, ml in zip(torch.chunk(tokens, n), torch.chunk(labels, n)):
            loss = loss_fn(cfg, params, mt, ml)
            loss.backward()
            total += float(loss.detach())
        out["losses"].append(total / n)
        with torch.no_grad():
            grads = {}
            for k, t in params.items():
                grads[k] = t.grad.div_(n)
                t.grad = None
                t.requires_grad_(False)
            norm = math.sqrt(sum(_sum_sq(g) for g in grads.values()))
            scale = min(job["clip"] / max(norm, 1e-9), 1.0)
            lr = adamw_lr(job, step)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for k, p in params.items():
                g = grads.pop(k).mul_(scale).reshape(-1)
                flat = p.view(-1)
                decay = wd if p.ndim >= 2 else 0.0
                for s in range(0, flat.numel(), chunk):
                    e = min(flat.numel(), s + chunk)
                    mk = b1 * m[k].read(s, e) + (1 - b1) * g[s:e]
                    vk = b2 * v[k].read(s, e) + (1 - b2) * g[s:e] * g[s:e]
                    upd = (mk / bc1) / (torch.sqrt(vk / bc2) + eps)
                    flat[s:e] -= lr * (upd + decay * flat[s:e])
                    m[k].write(s, e, mk)
                    v[k].write(s, e, vk)
                del g
                if step == 1:
                    out["grad_norms"][k] = m[k].norm() / (1 - b1)
    return out


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill(cfg: dict, params: dict, tokens: torch.Tensor, cap: int):
    """The serve state after ``tokens (b, s)`` in the engine's documented
    layout, f32: ``ssm`` (L, b, nh, dh, ds) the final SSD states, ``conv``
    (L, b, width - 1, conv_dim) the mixers' last raw (pre-conv) inputs,
    ``pos`` = s; and the last token's logits (b, vocab).  A pure SSM keeps
    no cache of positions, so ``cap`` sizes nothing."""
    b, s = tokens.shape
    L = cfg["n_layers"]
    state = {"pos": s,
             "ssm": torch.zeros((L, b, ssm_heads(cfg), cfg["ssm_head_dim"],
                                 cfg["ssm_state"]), device=tokens.device),
             "conv": torch.zeros((L, b, cfg["conv_width"] - 1,
                                  conv_dim(cfg)), device=tokens.device)}
    x = params[("embed",)][tokens.long()]
    for i in range(L):
        x, state["ssm"][i], state["conv"][i] = layer(
            cfg, layer_view(params, i), x)
    return state, logits(params, x[:, -1:])[:, -1]

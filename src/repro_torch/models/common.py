"""Shared model substrate: config, norms, rope, dense layers and their init.

Counterpart of ``repro/models/common.py``.  One ``ModelConfig`` covers every
architecture family of the reference (dense / moe / ssm / hybrid / vlm /
audio).  ``ShardRules`` names the mesh axes of the logical parallel dims, as
the reference's does; ``distributed.partition`` reads them to lay parameters,
optimizer state and batches out on a mesh (``launch.mesh``).  The model's
own activation constraint, ``shard``, is the identity, as the reference's
is outside a mesh: the port's mesh step runs each share's forward whole on
one device.

Parameters live in ``nn.Module``s.  Dense weights are stored in the layout
``nn.Linear`` uses, ``(d_out, d_in)`` (``DENSE_LAYOUT``), and applied with
``F.linear``; the reference stores ``(d_in, d_out)`` and computes
``x @ w``.  ``models/convert.py`` transposes between the two.

Precision follows the reference: dense weights are cast to the activation's
dtype at use; norms compute in f32 and cast back; rope rotates in f32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.mesh import PartitionSpec as P

#: Dense weights are ``(d_out, d_in)``: ``y = x @ w.T + b``.
DENSE_LAYOUT = "out_in"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                   # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 -> d_model // n_heads

    # attention details
    qkv_bias: bool = False
    out_bias: bool = False
    mlp_bias: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None           # sliding-window size (SWA layers)
    global_layers: Sequence[int] = ()      # full-attention layers in SWA stacks
    norm: str = "rmsnorm"                  # rmsnorm | layernorm
    act: str = "silu"                      # silu | gelu
    parallel_block: bool = False           # attn + mlp in parallel (command-r)
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_two_d: bool = False
    moe_groups: int = 1
    kv_dtype: str = ""          # serve-cache dtype override (e.g. 'int8')

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_heads: int = 0                     # 0 -> derived from d_inner/ssm_head_dim
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq_divisor: int = 2
    dec_seq_divisor: int = 8

    # vlm stub frontend
    n_patches: int = 0

    # training-time details
    dtype: str = "bfloat16"
    remat: str = "full"
    attn_block: int = 1024
    use_scan_attention: bool = True
    scan_unroll: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or (self.d_inner // self.ssm_head_dim)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline accounting)."""
        D, F_, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        Hq, Hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = D * Hq * dh + 2 * D * Hkv * dh + Hq * dh * D
        mlp = 3 * D * F_
        if self.family == "moe":
            mlp = self.n_experts * 3 * D * self.d_ff + D * self.n_experts
            mlp += self.n_shared_experts * 3 * D * self.d_ff
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, ds, g = self.d_inner, self.ssm_state, self.ssm_groups
            nh = self.n_ssm_heads
            ssm = D * (2 * di + 2 * g * ds + nh) + di * D + 3 * nh
        blocks = {
            "dense": attn + mlp, "vlm": attn + mlp, "audio": attn + mlp,
            "moe": attn + mlp,
            "ssm": ssm,
            "hybrid": attn + mlp + ssm,
        }[self.family]
        total = L * blocks + 2 * V * D  # embed + unembed
        if self.family == "audio":
            total += self.n_enc_layers * (attn + mlp) + L * attn
        return int(total)

    def active_param_count(self) -> int:
        """Active-per-token params (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        D, V, L = self.d_model, self.vocab_size, self.n_layers
        Hq, Hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = D * Hq * dh + 2 * D * Hkv * dh + Hq * dh * D
        mlp = (self.top_k + self.n_shared_experts) * 3 * D * self.d_ff \
            + D * self.n_experts
        return int(L * (attn + mlp) + 2 * V * D)


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardRules:
    """Axis names for the logical parallel dims.

    dp: data-parallel mesh axes (('pod','data') multi-pod, ('data',) single)
    tp: tensor-parallel axis   ('model')
    fsdp: axis params/optimizer are additionally sharded over (ZeRO-3); None
          replicates params over dp.
    sp: sequence-parallel axis for long-context activations; None disables.
    """

    dp: tuple = ("data",)
    tp: Optional[str] = "model"
    fsdp: Optional[str] = "data"
    sp: Optional[str] = None

    def act(self, *rest) -> P:
        """Activation spec: batch over dp, then given axes."""
        return P(self.dp, *rest)


def shard(x: torch.Tensor, spec: P) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` outside a mesh: ``x``
    unchanged."""
    return x


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layernorm(x, scale, bias=None, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.var(xf, -1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


class Norm(nn.Module):
    """Norm parameters: an f32 ``scale`` (and ``bias`` for layernorm)."""

    def __init__(self, cfg: ModelConfig, d: int, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(d, **f32), requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(d, **f32), requires_grad=False)
                     if cfg.norm == "layernorm" else None)


def norm_init(cfg: ModelConfig, d: int, device=None) -> Norm:
    return Norm(cfg, d, device)


def norm_apply(cfg: ModelConfig, x: torch.Tensor, p: Norm) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p.scale)
    return layernorm(x, p.scale, p.bias)


def activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding; x: (..., s, dh), positions: (s,) or (b, s)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    while cos.ndim < x.ndim:   # broadcast over the head axis
        cos, sin = cos[..., None, :, :], sin[..., None, :, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class _MetaDraws:
    """Stands in for a ``torch.Generator`` to build a model on the meta
    device (``torch.Generator`` has no meta device): shapes and dtypes,
    nothing drawn."""

    device = torch.device("meta")


#: Pass as the generator of an ``init`` to build the model on ``meta``.
META = _MetaDraws()


class Dense(nn.Module):
    """A dense layer's parameters in ``DENSE_LAYOUT``: ``weight (d_out,
    d_in)`` and an optional ``bias (d_out,)``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.weight = nn.Parameter(torch.empty(d_out, d_in, **kw),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(d_out, **kw),
                                  requires_grad=False) if bias else None)


def normal(shape, scale: float, generator: torch.Generator, dtype
           ) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in f32 on the generator's device, then
    stored in ``dtype`` (the reference draws f32 and casts at use).  On
    ``META`` nothing is drawn or allocated."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    t = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return t.mul_(scale).to(dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               scale: float = 0.02, bias: bool = False,
               dtype=torch.float32) -> Dense:
    p = Dense(d_in, d_out, bias, device=generator.device, dtype=dtype)
    p.weight.data = normal((d_out, d_in), scale, generator, dtype)
    return p


def dense_apply(p: Dense, x: torch.Tensor) -> torch.Tensor:
    b = None if p.bias is None else p.bias.to(x.dtype)
    return F.linear(x, p.weight.to(x.dtype), b)

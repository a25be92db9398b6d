"""Feed-forward layers: gated dense MLP and sort-based capacity MoE.

Counterpart of ``repro/models/mlp.py``.  The MoE dispatch follows the
reference step for step, so that the same assignments are kept and dropped:
the router in f32, softmax, top-k, the Switch-style aux loss; assignments
stably sorted by expert id, each expert taking a contiguous capacity-C slab
of the sorted stream (the capacity from the token count, with the decode
floor and the ``moe_two_d`` rounding), a sentinel slot of weight 0 for the
empty ones, one batched product per projection over the experts, and a
scatter-add back to the tokens.  The expert products are plain
``torch.einsum`` / ``bmm``, as the reference leaves its ``jnp.einsum`` to
XLA outside any Pallas kernel.  Mesh sharding constraints are no-ops on one
card and are left out.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import (
    Dense, ModelConfig, activation, dense_apply, dense_init, normal,
)


class MLP(nn.Module):
    """Gated MLP: ``wd(act(wg x) * wu x)``."""

    def __init__(self, wg: Dense, wu: Dense, wd: Dense):
        super().__init__()
        self.wg, self.wu, self.wd = wg, wu, wd


def init_dense(cfg: ModelConfig, generator: torch.Generator,
               d_ff: int | None = None, dtype=torch.float32) -> MLP:
    f = d_ff or cfg.d_ff
    scale_o = 0.02 / (2 * cfg.n_layers) ** 0.5
    g, d = generator, cfg.d_model
    return MLP(dense_init(g, d, f, bias=cfg.mlp_bias, dtype=dtype),
               dense_init(g, d, f, bias=cfg.mlp_bias, dtype=dtype),
               dense_init(g, f, d, scale=scale_o, bias=cfg.mlp_bias,
                          dtype=dtype))


def apply_dense(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = activation(cfg, dense_apply(p.wg, x)) * dense_apply(p.wu, x)
    return dense_apply(p.wd, h)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


class MoE(nn.Module):
    """Routed experts: ``router`` (a ``Dense`` d -> e, always f32: the
    reference routes in f32), the expert weights ``wg``, ``wu`` (e, d, f)
    and ``wd`` (e, f, d) in the reference's layout (the operands of its
    einsums), and ``shared`` (an ``MLP`` of width d_ff * n_shared, or
    None)."""

    def __init__(self, router: Dense, wg: torch.Tensor, wu: torch.Tensor,
                 wd: torch.Tensor, shared: MLP | None):
        super().__init__()
        self.router = router
        self.wg = nn.Parameter(wg, requires_grad=False)
        self.wu = nn.Parameter(wu, requires_grad=False)
        self.wd = nn.Parameter(wd, requires_grad=False)
        self.shared = shared


def init_moe(cfg: ModelConfig, generator: torch.Generator,
             dtype=torch.float32) -> MoE:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    scale_o = 0.02 / (2 * cfg.n_layers) ** 0.5
    g = generator
    shared = None
    if cfg.n_shared_experts:
        shared = init_dense(cfg, g, d_ff=f * cfg.n_shared_experts,
                            dtype=dtype)
    return MoE(dense_init(g, d, e), normal((e, d, f), 0.02, g, dtype),
               normal((e, d, f), 0.02, g, dtype),
               normal((e, f, d), scale_o, g, dtype), shared)


def capacity(cfg: ModelConfig, t: int, two_d: bool) -> int:
    """Slots per expert for ``t`` tokens: the reference's formula (Python's
    ``round``), its decode floor, and the ``moe_two_d`` rounding up to a
    multiple of 128 where ``two_d``."""
    k = cfg.top_k
    cap = int(max(1, round(t * k / cfg.n_experts * cfg.capacity_factor)))
    cap = max(cap, min(t, 2 * k))            # decode floor: tiny t
    if two_d:
        cap = -(-cap // 128) * 128
    return cap


def _route(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """Router over x (..., d): f32 probs (..., e), the renormalized top-k
    weights and ids (..., k), and the aux loss over all tokens."""
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(dense_apply(p.router, x.float()), dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    n = top_i.numel()
    me = probs.reshape(-1, e).mean(0)
    ce = torch.zeros(e, device=x.device).index_add_(
        0, top_i.reshape(-1), torch.ones(n, device=x.device)) / n
    aux = cfg.router_aux_coef * e * torch.sum(me * ce)
    return top_p, top_i, aux


def _dispatch(eid: torch.Tensor, wgt: torch.Tensor, k: int, e: int,
              cap: int):
    """Sort-based dispatch of the flat assignments ``eid``, ``wgt`` (...,
    n = tokens * k) -> ``tok`` (..., e, cap) token ids and ``w_tok`` (...,
    e, cap) weights, 0 in the sentinel slots (which point at token 0)."""
    n = eid.shape[-1]
    lead = eid.shape[:-1]
    order = torch.argsort(eid, dim=-1, stable=True)
    tid_s = order // k
    wgt_s = torch.gather(wgt, -1, order)
    counts = torch.zeros(lead + (e,), dtype=torch.int64,
                         device=eid.device).scatter_add_(
        -1, eid, torch.ones_like(eid))
    offsets = torch.cumsum(counts, -1) - counts
    slot = torch.arange(cap, device=eid.device)
    take = offsets[..., :, None] + slot
    valid = slot < counts[..., :, None]
    take = torch.where(valid, torch.clamp(take, max=n - 1), n)
    zero = torch.zeros(lead + (1,), dtype=tid_s.dtype, device=eid.device)
    tid_pad = torch.cat([tid_s, zero], -1)
    wgt_pad = torch.cat([wgt_s, zero.to(wgt_s.dtype)], -1)
    flat = take.reshape(lead + (-1,))
    tok = torch.gather(tid_pad, -1, flat).reshape(take.shape)
    w_tok = torch.where(valid, torch.gather(wgt_pad, -1, flat).reshape(
        take.shape), 0.0)
    return tok, w_tok


def _experts(cfg: ModelConfig, p: MoE, xe: torch.Tensor) -> torch.Tensor:
    """Expert MLPs of the gathered tokens xe (..., e, cap, d)."""
    dt = xe.dtype
    h = activation(cfg, torch.einsum("...ecd,edf->...ecf", xe, p.wg.to(dt)))
    h = h * torch.einsum("...ecd,edf->...ecf", xe, p.wu.to(dt))
    return torch.einsum("...ecf,efd->...ecd", h, p.wd.to(dt))


def apply_moe(cfg: ModelConfig, p: MoE, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (out, aux_loss).  Sort-based top-k capacity routing;
    ``cfg.moe_groups > 1`` routes within groups (``apply_moe_grouped``)."""
    if cfg.moe_groups > 1:
        return apply_moe_grouped(cfg, p, x)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xf = x.reshape(t, d)
    top_p, top_i, aux = _route(cfg, p, xf)
    tok, w_tok = _dispatch(top_i.reshape(-1), top_p.reshape(-1), k, e,
                           capacity(cfg, t, cfg.moe_two_d))
    oe = _experts(cfg, p, xf[tok])                           # (e, cap, d)
    oe = oe * w_tok[..., None].to(oe.dtype)
    out = torch.zeros((t, d), dtype=oe.dtype, device=x.device).index_add_(
        0, tok.reshape(-1), oe.reshape(-1, d))
    if p.shared is not None:
        out = out + apply_dense(cfg, p.shared, xf)
    return out.reshape(b, s, d), aux


def apply_moe_grouped(cfg: ModelConfig, p: MoE, x: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard-style grouped dispatch: the tokens split into
    ``cfg.moe_groups`` groups, routing and capacity within each group.  With
    a capacity factor high enough that nothing drops it computes the same
    function as the ungrouped dispatch."""
    b, s, d = x.shape
    e, k, g = cfg.n_experts, cfg.top_k, cfg.moe_groups
    t = b * s
    if t % g:
        raise ValueError(f"{t} tokens do not split into {g} groups")
    tg = t // g
    xg = x.reshape(g, tg, d)
    top_p, top_i, aux = _route(cfg, p, xg)                   # (g, tg, k)
    tok, w_tok = _dispatch(top_i.reshape(g, tg * k),
                           top_p.reshape(g, tg * k), k, e,
                           capacity(cfg, tg, False))         # (g, e, cap)
    rows = torch.arange(g, device=x.device)[:, None, None]
    oe = _experts(cfg, p, xg[rows, tok])                     # (g, e, cap, d)
    oe = oe * w_tok[..., None].to(oe.dtype)
    out = torch.zeros((t, d), dtype=oe.dtype, device=x.device).index_add_(
        0, (tok + rows * tg).reshape(-1), oe.reshape(-1, d))
    if p.shared is not None:
        out = out + apply_dense(cfg, p.shared, x.reshape(t, d))
    return out.reshape(b, s, d), aux

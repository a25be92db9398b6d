"""The MoE dispatch with every empty capacity slot pointing at token 0.

A restatement of ``repro_torch.models.mlp._dispatch`` as it stood before
its sentinel slots were spread over the tokens (and of the reference's
dispatch, ``repro/models/mlp.py``): the baseline the spread dispatch is
held to.  Same signature, so a test can put it in ``mlp._dispatch``'s
place.  Imports neither JAX nor the reference, so the card's tests can use
it.
"""
import math

import torch


def token0_dispatch(eid: torch.Tensor, wgt: torch.Tensor, k: int, e: int,
                    cap: int):
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


def pile_bound(k: int, e: int, cap: int, t: int) -> int:
    """The most slots one token may hold among a dispatch's e x cap slots
    over t tokens: its k kept assignments and its share of the sentinels."""
    return k + math.ceil(e * cap / t)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()))


def largest_run(tok: torch.Tensor, t: int) -> int:
    """The most slots of any one token in each dispatch of ``tok`` (...,
    e, cap) over t tokens, the largest over the leading dims."""
    flat = tok.reshape(-1, tok.shape[-2] * tok.shape[-1])
    return max(int(torch.bincount(r, minlength=t).max()) for r in flat)

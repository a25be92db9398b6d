"""Attention layer: GQA + RoPE + (optional) sliding window.

Counterpart of ``repro/models/attention.py``.

* ``attend``        -- full-sequence attention through ``ops.flash_attention``
  (K3 on the card, its plain online-softmax version on the CPU): causal
  self-attention, or none (whisper's encoder and its cross-attention, where
  the queries and keys differ in length).  The reference's jnp
  ``attend_scan`` / ``attend_full`` mirror the same function; the port has
  one path.
* ``attend_decode`` -- one query token against a KV cache (ring buffer for
  SWA layers), plain torch: (1, S) logits are tiny and the reference has no
  Pallas kernel for it.

q heads (b, hq, s, dh) fold to (b, hkv, group, s, dh), so K/V are never
repeated in memory.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.common import (
    Dense, ModelConfig, dense_apply, dense_init, rope,
)


class Attention(nn.Module):
    """Projections ``wq``, ``wk``, ``wv``, ``wo`` (``common.Dense``)."""

    def __init__(self, wq: Dense, wk: Dense, wv: Dense, wo: Dense):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def init(cfg: ModelConfig, generator: torch.Generator,
         dtype=torch.float32) -> Attention:
    dh = cfg.head_dim
    scale_o = 0.02 / (2 * cfg.n_layers) ** 0.5
    g, d = generator, cfg.d_model
    return Attention(
        dense_init(g, d, cfg.n_heads * dh, bias=cfg.qkv_bias, dtype=dtype),
        dense_init(g, d, cfg.n_kv_heads * dh, bias=cfg.qkv_bias, dtype=dtype),
        dense_init(g, d, cfg.n_kv_heads * dh, bias=cfg.qkv_bias, dtype=dtype),
        dense_init(g, cfg.n_heads * dh, d, scale=scale_o, bias=cfg.out_bias,
                   dtype=dtype),
    )


def query(cfg: ModelConfig, p: Attention, x: torch.Tensor,
          positions: torch.Tensor) -> torch.Tensor:
    """x: (b, s, d) -> q (b, hq, s, dh), rope applied."""
    b, s, _ = x.shape
    q = dense_apply(p.wq, x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    return rope(q.transpose(1, 2), positions, cfg.rope_theta)


def kv_of(cfg: ModelConfig, p: Attention, x: torch.Tensor):
    """x: (b, s, d) -> k, v (b, hkv, s, dh) without rope (whisper's
    cross-attention keys from the encoder output)."""
    b, s, _ = x.shape
    shape = (b, s, cfg.n_kv_heads, cfg.head_dim)
    return (dense_apply(p.wk, x).reshape(shape).transpose(1, 2),
            dense_apply(p.wv, x).reshape(shape).transpose(1, 2))


def qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor,
        positions: torch.Tensor):
    """x: (b, s, d) -> q (b, hq, s, dh), k/v (b, hkv, s, dh), rope applied."""
    k, v = kv_of(cfg, p, x)
    return (query(cfg, p, x, positions), rope(k, positions, cfg.rope_theta),
            v.contiguous())


def attend(cfg: ModelConfig, q, k, v, causal: bool = True,
           window=None) -> torch.Tensor:
    """Attention of one sequence (K3 through ``ops.flash_attention``):
    causal, or not (whisper's encoder, and its cross-attention with sq !=
    skv); ``window`` None for a global layer.
    (b, hq, sq, dh) x (b, hkv, skv, dh) -> (b, hq, sq, dh) in q's dtype."""
    return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window)


def merge_heads(out: torch.Tensor) -> torch.Tensor:
    """(b, hq, s, dh) -> (b, s, hq * dh), the input of ``wo``."""
    b, hq, s, dh = out.shape
    return out.transpose(1, 2).reshape(b, s, hq * dh)


# ---------------------------------------------------------------------------
# Decode with KV cache (full or ring-buffer/SWA)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """k/v: (b, hkv, cap, dh).  For SWA layers cap == window (ring)."""
    k: torch.Tensor
    v: torch.Tensor
    ring: bool

    @classmethod
    def create(cls, b, hkv, cap, dh, dtype, ring=False, device=None):
        return cls(
            k=torch.zeros((b, hkv, cap, dh), dtype=dtype, device=device),
            v=torch.zeros((b, hkv, cap, dh), dtype=dtype, device=device),
            ring=ring,
        )


def cache_update(cache: KVCache, k_new, v_new, pos: int) -> KVCache:
    """Insert one token's k/v at absolute position ``pos`` (ring-aware), IN
    PLACE (the reference returns updated copies; the port writes the one
    slot).  int8 caches (kv_dtype override) quantize with the reference's
    fixed scale of 16 -- its dry-run stand-in for per-head scaled KV
    quantization."""
    if cache.k.dtype != k_new.dtype:
        k_new = (k_new * 16.0).to(cache.k.dtype)
        v_new = (v_new * 16.0).to(cache.v.dtype)
    cap = cache.k.shape[2]
    slot = (pos % cap) if cache.ring else pos
    cache.k[:, :, slot:slot + 1] = k_new
    cache.v[:, :, slot:slot + 1] = v_new
    return cache


def attend_decode(cfg: ModelConfig, q, cache: KVCache, pos: int,
                  window=None) -> torch.Tensor:
    """q: (b, hq, 1, dh) vs cache; ``pos`` is the current absolute position."""
    b, hq, _, dh = q.shape
    cap, hkv = cache.k.shape[2], cache.k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, 1, dh).float() / float(dh) ** 0.5
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, cache.k.float())
    slots = torch.arange(cap, device=q.device)
    if cache.ring:
        # slot holds absolute position p iff p = latest write to that slot;
        # valid when the slot's position is within (pos-window, pos].
        age = (pos % cap - slots) % cap            # 0 == newest
        valid = age <= min(pos, cap - 1)
        if window is not None:
            valid &= age < window
    else:
        valid = slots <= pos
        if window is not None:
            valid &= slots > pos - window
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, cache.v.float())
    return out.reshape(b, hq, 1, dh).to(q.dtype)

"""Prefill / decode for the hybrid family (hymba).

Counterpart of ``repro/serving/engine.py``.  State layout (a dict):

  ring_k / ring_v (L, B, Hkv, W, dh)      SWA ring buffers
  glob_k / glob_v (nG, B, Hkv, cap, dh)   full caches for the global layers
  ssm / conv      (L, B, nh, dh, ds) / (L, B, w-1, conv_dim)
  pos             int                     absolute decode position

Prefill runs the full-sequence stack (K3 and K4 once per layer on the card)
and packs its kv into the rings and global caches, its final SSD states and
raw conv tails into ``ssm`` / ``conv``.  Decode unrolls the layers with
plain-torch attention against the caches and the O(1) SSM step; the ring
buffers keep hybrid decode O(W) in memory for SWA layers.

The reference is functional and returns updated copies; ``decode_step``
here updates the state's tensors IN PLACE (one slot per cache and layer)
and returns the same dict.  ``pos`` is a host int, so a decode step never
waits on the card to know where to write.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ModelConfig, dense_apply, norm_apply


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------


def _kv_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.kv_dtype) if cfg.kv_dtype else cfg.compute_dtype


def state_shapes(cfg: ModelConfig, batch: int, cap: int) -> dict:
    """``name -> (shape, dtype)`` of the serve state's tensors (``pos`` is
    an int)."""
    tfm._require_ported(cfg)
    dt = _kv_dtype(cfg)
    dh, L, B, Hkv = cfg.head_dim, cfg.n_layers, batch, cfg.n_kv_heads
    w = min(cfg.window or cap, cap)
    ng = max(len(cfg.global_layers), 1)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "ring_k": ((L, B, Hkv, w, dh), dt),
        "ring_v": ((L, B, Hkv, w, dh), dt),
        "glob_k": ((ng, B, Hkv, cap, dh), dt),
        "glob_v": ((ng, B, Hkv, cap, dh), dt),
        "ssm": ((L, B, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                torch.float32),
        "conv": ((L, B, cfg.conv_width - 1, conv_dim), dt),
    }


def init_state(cfg: ModelConfig, batch: int, cap: int, device=None) -> dict:
    state = {name: torch.zeros(shape, dtype=dtype, device=device)
             for name, (shape, dtype) in state_shapes(cfg, batch, cap).items()}
    state["pos"] = 0
    return state


# ---------------------------------------------------------------------------
# Decode step (one new token, unrolled layers)
# ---------------------------------------------------------------------------


def decode_step(cfg: ModelConfig, params: tfm.Transformer, state: dict,
                tokens: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """tokens: (B, 1) -> (state, logits (B, vocab)); ``state`` is updated in
    place."""
    tfm._require_ported(cfg)
    pos = state["pos"]
    x = tfm.embed_tokens(cfg, params, tokens)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    glob = {li: g for g, li in enumerate(cfg.global_layers)}
    for i, p in enumerate(params.layers):
        h = norm_apply(cfg, x, p.norm1)
        q, k, v = attn.qkv(cfg, p.attn, h, positions)
        if i in glob:
            cache = attn.KVCache(k=state["glob_k"][glob[i]],
                                 v=state["glob_v"][glob[i]], ring=False)
            window = None
        else:
            cache = attn.KVCache(k=state["ring_k"][i], v=state["ring_v"][i],
                                 ring=True)
            window = cfg.window
        cache = attn.cache_update(cache, k, v, pos)
        out = attn.attend_decode(cfg, q, cache, pos, window=window)
        b, hq, _, dh = out.shape
        a_out = dense_apply(p.attn.wo, out.transpose(1, 2).reshape(b, 1, hq * dh))
        st = ssm_mod.SSMState(ssm=state["ssm"][i], conv=state["conv"][i])
        y, st = ssm_mod.apply_step(cfg, p.ssm, h, st)
        state["ssm"][i].copy_(st.ssm)
        state["conv"][i].copy_(st.conv)
        x = x + 0.5 * (a_out + y)
        x = x + mlp_mod.apply_dense(cfg, p.mlp, norm_apply(cfg, x, p.norm2))
    logits = tfm.logits_from_x(cfg, params, x)[:, -1]
    state["pos"] = pos + 1
    return state, logits


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params: tfm.Transformer, batch: dict, cap: int
            ) -> tuple[dict, torch.Tensor]:
    """Run the full-sequence stack, pack its kv / ssm into the serve state.

    batch: {tokens (B, S)}.  Returns (state at pos=S, last-token logits
    (B, vocab)).
    """
    tfm._require_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = tfm.embed_tokens(cfg, params, tokens)
    positions = torch.arange(s, device=x.device)
    x, kept = tfm.run_stack(cfg, params.layers, x, positions)
    state = init_state(cfg, b, cap, x.device)

    w = state["ring_k"].shape[3]
    n_fill = min(s, w)
    slots = torch.arange(s - n_fill, s, device=x.device) % w
    glob = {li: g for g, li in enumerate(cfg.global_layers)}
    for i, aux in enumerate(kept):
        k, v = aux["kv"]
        state["ring_k"][i][:, :, slots] = k[:, :, s - n_fill:].to(
            state["ring_k"].dtype)
        state["ring_v"][i][:, :, slots] = v[:, :, s - n_fill:].to(
            state["ring_v"].dtype)
        if i in glob:
            state["glob_k"][glob[i], :, :, :s] = k
            state["glob_v"][glob[i], :, :, :s] = v
        state["ssm"][i] = aux["ssm"].ssm
        state["conv"][i] = aux["ssm"].conv
    state["pos"] = s
    logits = tfm.logits_from_x(cfg, params, x[:, -1:])[:, -1]
    return state, logits

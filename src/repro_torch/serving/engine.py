"""Prefill / decode for every architecture family.

Counterpart of ``repro/serving/engine.py``.  State layout (a dict):

  kv_k / kv_v     (L, B, Hkv, cap, dh)    full causal caches (dense / vlm /
                                          moe; whisper's decoder at cap / 8)
  ring_k / ring_v (L, B, Hkv, W, dh)      SWA ring buffers (hybrid)
  glob_k / glob_v (nG, B, Hkv, cap, dh)   full caches for the global layers
  ssm / conv      (L, B, nh, dh, ds) / (L, B, w-1, conv_dim)
  xk / xv         (L, B, Hkv, cap / 2, dh) whisper cross-attention kv
  pos             int                     absolute decode position
  enc_len         int                     whisper: encoder frames in xk / xv

Prefill runs the full-sequence stack (K3 once per attention layer, K4 once
per SSM layer on the card) and packs its kv into the caches, its final SSD
states and raw conv tails into ``ssm`` / ``conv``.  Decode unrolls the
layers with plain-torch attention against the caches and the O(1) SSM step;
the ring buffers keep hybrid decode O(W) in memory for SWA layers.

Where the reference's decode departs from its own full forward, the port
computes what the full forward computes (ROADMAP.md queue C):

* command-r's parallel block: the reference's ``decode_step`` adds the MLP
  of ``norm2(x + attn)`` in series (both branches of its ``if
  cfg.parallel_block`` are the same); the port decodes ``x + attn(norm1 x)
  + mlp(norm1 x)``, as ``block_forward`` does.
* whisper's cross-attention: ``prefill_audio`` packs Se encoder keys into
  a cache of cap / 2 slots and the reference's decode attends every slot,
  the zero padding included; the port keeps the true length as
  ``enc_len`` and masks the slots past it.

The reference is functional and returns updated copies; ``decode_step``
here updates the state's tensors IN PLACE (one slot per cache and layer)
and returns the same dict.  ``pos`` and ``enc_len`` are host ints, so a
decode step never waits on the card to know where to write or read.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (
    ModelConfig, ShardRules, dense_apply, norm_apply,
)

#: The families whose layers hold a full causal kv cache.
KV_FAMILIES = ("dense", "vlm", "moe")


def host_ints(cfg: ModelConfig) -> tuple[str, ...]:
    """The state's entries that are host ints, not tensors."""
    return ("pos", "enc_len") if cfg.family == "audio" else ("pos",)


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------


def _kv_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.kv_dtype) if cfg.kv_dtype else cfg.compute_dtype


def state_shapes(cfg: ModelConfig, batch: int, cap: int) -> dict:
    """``name -> (shape, dtype)`` of the serve state's tensors (the host
    ints of ``host_ints`` are not among them)."""
    dt = _kv_dtype(cfg)
    dh, L, B, Hkv = cfg.head_dim, cfg.n_layers, batch, cfg.n_kv_heads
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    ssm = {"ssm": ((L, B, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                   torch.float32),
           "conv": ((L, B, cfg.conv_width - 1, conv_dim), dt)}
    fam = cfg.family
    if fam in KV_FAMILIES:
        return {"kv_k": ((L, B, Hkv, cap, dh), dt),
                "kv_v": ((L, B, Hkv, cap, dh), dt)}
    if fam == "audio":
        cap_dec = max(cap // cfg.dec_seq_divisor, 64)
        se = cap // cfg.enc_seq_divisor
        return {"kv_k": ((L, B, Hkv, cap_dec, dh), dt),
                "kv_v": ((L, B, Hkv, cap_dec, dh), dt),
                "xk": ((L, B, Hkv, se, dh), dt),
                "xv": ((L, B, Hkv, se, dh), dt)}
    if fam == "ssm":
        return ssm
    if fam == "hybrid":
        w = min(cfg.window or cap, cap)
        ng = max(len(cfg.global_layers), 1)
        return {"ring_k": ((L, B, Hkv, w, dh), dt),
                "ring_v": ((L, B, Hkv, w, dh), dt),
                "glob_k": ((ng, B, Hkv, cap, dh), dt),
                "glob_v": ((ng, B, Hkv, cap, dh), dt), **ssm}
    raise ValueError(f"unknown family {fam!r}")


def init_state(cfg: ModelConfig, batch: int, cap: int, device=None) -> dict:
    state = {name: torch.zeros(shape, dtype=dtype, device=device)
             for name, (shape, dtype) in state_shapes(cfg, batch, cap).items()}
    for name in host_ints(cfg):
        state[name] = 0
    return state


# ---------------------------------------------------------------------------
# Decode step (one new token, unrolled layers)
# ---------------------------------------------------------------------------


def _decode_attn(cfg: ModelConfig, p_attn: attn.Attention, h, positions,
                 cache: attn.KVCache, pos: int, window) -> torch.Tensor:
    """Self-attention of one token: write its k / v into ``cache`` (in
    place), attend, project."""
    q, k, v = attn.qkv(cfg, p_attn, h, positions)
    attn.cache_update(cache, k, v, pos)
    out = attn.attend_decode(cfg, q, cache, pos, window=window)
    return dense_apply(p_attn.wo, attn.merge_heads(out))


def decode_step(cfg: ModelConfig, params: tfm.Transformer, state: dict,
                tokens: torch.Tensor, rules: ShardRules | None = None
                ) -> tuple[dict, torch.Tensor]:
    """tokens: (B, 1) -> (state, logits (B, vocab)); ``state`` is updated in
    place.  ``rules`` is the reference's; without a mesh it changes
    nothing."""
    pos = state["pos"]
    fam = cfg.family
    x = tfm.embed_tokens(cfg, params, tokens)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    glob = {li: g for g, li in enumerate(cfg.global_layers)}
    for i, p in enumerate(params.layers):
        if fam == "ssm":
            st = ssm_mod.SSMState(ssm=state["ssm"][i], conv=state["conv"][i])
            y, st = ssm_mod.apply_step(cfg, p.ssm, norm_apply(cfg, x, p.norm1),
                                       st)
            state["ssm"][i].copy_(st.ssm)
            state["conv"][i].copy_(st.conv)
            x = x + y
            continue

        h = norm_apply(cfg, x, p.norm1)
        if fam == "hybrid" and i not in glob:
            cache = attn.KVCache(k=state["ring_k"][i], v=state["ring_v"][i],
                                 ring=True)
            window = cfg.window
        elif fam == "hybrid":
            cache = attn.KVCache(k=state["glob_k"][glob[i]],
                                 v=state["glob_v"][glob[i]], ring=False)
            window = None
        else:
            cache = attn.KVCache(k=state["kv_k"][i], v=state["kv_v"][i],
                                 ring=False)
            window = None if fam == "audio" else cfg.window
        a_out = _decode_attn(cfg, p.attn, h, positions, cache, pos, window)

        if fam == "hybrid":
            st = ssm_mod.SSMState(ssm=state["ssm"][i], conv=state["conv"][i])
            y, st = ssm_mod.apply_step(cfg, p.ssm, h, st)
            state["ssm"][i].copy_(st.ssm)
            state["conv"][i].copy_(st.conv)
            x = x + 0.5 * (a_out + y)
        elif cfg.parallel_block:
            x = x + a_out + mlp_mod.apply_dense(cfg, p.mlp, h)
            continue
        else:
            x = x + a_out
        if fam == "audio":
            # Cross-attention against the static encoder kv: the first
            # enc_len slots hold the encoder's frames, the rest is padding.
            q = attn.query(cfg, p.xattn, norm_apply(cfg, x, p.norm_x),
                           positions)
            xc = attn.KVCache(k=state["xk"][i], v=state["xv"][i], ring=False)
            out = attn.attend_decode(cfg, q, xc, state["enc_len"] - 1)
            x = x + dense_apply(p.xattn.wo, attn.merge_heads(out))
        h = norm_apply(cfg, x, p.norm2)
        if fam == "moe":
            m_out, _ = mlp_mod.apply_moe(cfg, p.moe, h)
        else:
            m_out = mlp_mod.apply_dense(cfg, p.mlp, h)
        x = x + m_out
    logits = tfm.logits_from_x(cfg, params, x)[:, -1]
    state["pos"] = pos + 1
    return state, logits


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params: tfm.Transformer, batch: dict, cap: int,
            rules: ShardRules | None = None) -> tuple[dict, torch.Tensor]:
    """Run the full-sequence stack, pack its kv / ssm into the serve state.

    batch: {tokens (B, S)}, and for vlm optionally {patch_embeds (B, P, D)},
    prepended to the token embeddings (positions run over both).  Returns
    (state at pos = P + S, last-token logits (B, vocab)).  The audio family
    raises, as the reference's does: it prefills through ``prefill_audio``.
    ``rules``, as in ``decode_step``, changes nothing without a mesh.
    """
    if cfg.family == "audio":
        raise NotImplementedError(
            "audio prefill goes through prefill_audio (encode_audio + "
            "cross-kv packing)")
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x = tfm.embed_tokens(cfg, params, tokens)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    x, kept = tfm.run_stack(cfg, params.layers, x, positions)
    state = init_state(cfg, b, cap, x.device)

    if cfg.family == "hybrid":
        w = state["ring_k"].shape[3]
        n_fill = min(s, w)
        slots = torch.arange(s - n_fill, s, device=x.device) % w
    glob = {li: g for g, li in enumerate(cfg.global_layers)}
    for i, aux in enumerate(kept):
        if cfg.family in KV_FAMILIES:
            k, v = aux["kv"]
            state["kv_k"][i, :, :, :s] = k
            state["kv_v"][i, :, :, :s] = v
        if cfg.family == "hybrid":
            k, v = aux["kv"]
            state["ring_k"][i][:, :, slots] = k[:, :, s - n_fill:].to(
                state["ring_k"].dtype)
            state["ring_v"][i][:, :, slots] = v[:, :, s - n_fill:].to(
                state["ring_v"].dtype)
            if i in glob:
                state["glob_k"][glob[i], :, :, :s] = k
                state["glob_v"][glob[i], :, :, :s] = v
        if "ssm" in aux:
            state["ssm"][i] = aux["ssm"].ssm
            state["conv"][i] = aux["ssm"].conv
    state["pos"] = s
    logits = tfm.logits_from_x(cfg, params, x[:, -1:])[:, -1]
    return state, logits


def prefill_audio(cfg: ModelConfig, params: tfm.Transformer, batch: dict,
                  cap: int, rules: ShardRules | None = None
                  ) -> tuple[dict, torch.Tensor]:
    """Whisper: encode ``frames (B, Se, D)``, pack the cross kv (the first
    min(Se, cap / 2) frames; their count is the state's ``enc_len``), and
    prefill the decoder prompt ``tokens (B, S)``.  Returns (state at pos =
    S, last-token logits (B, vocab))."""
    enc_out = tfm.encode_audio(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = tfm.embed_tokens(cfg, params, tokens)
    positions = torch.arange(s, device=x.device)
    x, kept = tfm.run_dec_stack_audio(cfg, params, x, positions, enc_out)
    state = init_state(cfg, b, cap, x.device)
    se = min(enc_out.shape[1], state["xk"].shape[3])
    for i, aux in enumerate(kept):
        k, v = aux["kv"]
        kx, vx = aux["xkv"]
        state["kv_k"][i, :, :, :s] = k
        state["kv_v"][i, :, :, :s] = v
        state["xk"][i, :, :, :se] = kx[:, :, :se]
        state["xv"][i, :, :, :se] = vx[:, :, :se]
    state["pos"] = s
    state["enc_len"] = se
    logits = tfm.logits_from_x(cfg, params, x[:, -1:])[:, -1]
    return state, logits

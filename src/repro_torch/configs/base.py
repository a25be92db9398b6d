"""Shared helpers for architecture configs: the shape grid, the input
specs of each cell and the tiny same-family config of the CPU tests.

Counterpart of ``repro/configs/base.py``.  Each
``repro_torch/configs/<id>.py`` exposes ``make_config()`` (the full config,
dims verbatim from the reference), ``reduced()`` and ``ARCH``.
``input_specs`` gives ``(shape, dtype)`` tuples where the reference gives
``jax.ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import ModelConfig

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """``(shape, dtype)`` of every model input of this cell, in the
    reference's nesting: ``{"batch": {...}}`` for train and prefill,
    ``{"state": ..., "tokens": ...}`` for decode (the serve state of
    ``engine.state_shapes`` with its host ints ``pos`` (and ``enc_len``)
    as int32 scalars)."""
    from repro_torch.serving import engine

    sh = SHAPES[shape_name]
    s, b, kind = sh["seq_len"], sh["global_batch"], sh["kind"]
    i32 = torch.int32
    act = cfg.compute_dtype

    if kind in ("train", "prefill"):
        labels = kind == "train"
        if cfg.family == "audio":
            se, sd = s // cfg.enc_seq_divisor, s // cfg.dec_seq_divisor
            batch = {"frames": ((b, se, cfg.d_model), act),
                     "tokens": ((b, sd), i32)}
            if labels:
                batch["labels"] = ((b, sd), i32)
        elif cfg.family == "vlm":
            st = s - cfg.n_patches
            batch = {"tokens": ((b, st), i32)}
            if labels:
                batch["labels"] = ((b, st), i32)
            batch["patch_embeds"] = ((b, cfg.n_patches, cfg.d_model), act)
        else:
            batch = {"tokens": ((b, s), i32)}
            if labels:
                batch["labels"] = ((b, s), i32)
        return {"batch": batch}

    # decode: one new token against a seq_len cache
    state = dict(engine.state_shapes(cfg, b, s))
    for name in engine.host_ints(cfg):
        state[name] = ((), i32)
    return {"state": state, "tokens": ((b, 1), i32)}


def reduced_common(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU tests (the reference's values)."""
    small = dict(
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=256,
        vocab_size=512,
        d_head=32,
        dtype="float32",
        remat="none",
        attn_block=64,
    )
    if cfg.family == "moe":
        small.update(n_experts=8, top_k=2, d_ff=64,
                     n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=16, ssm_head_dim=16, ssm_heads=0)
    if cfg.family == "hybrid":
        small.update(window=32, global_layers=(0,))
    if cfg.family == "vlm":
        small.update(n_patches=16)
    if cfg.family == "audio":
        small.update(n_enc_layers=2)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)

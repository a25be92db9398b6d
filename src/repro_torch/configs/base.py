"""Shared helpers for architecture configs: the shape grid and the tiny
same-family config of the CPU tests.

Counterpart of ``repro/configs/base.py`` (``SHAPES``, ``reduced_common``).
Each ``repro_torch/configs/<id>.py`` exposes ``make_config()`` (the full
config, dims verbatim from the reference), ``reduced()`` and ``ARCH``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


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

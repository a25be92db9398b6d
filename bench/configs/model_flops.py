"""The model FLOPs of a configuration: what a pass requires, counted from
the configuration file's sizes, the same however the program computes it.

Per token, 2 FLOPs per multiply-add of every dense product it goes through
(the attention projections; the MLP, or for an MoE the router and its
``top_k`` experts only; the SSM mixer's projections) and of the unembedding
for the rows whose logits are computed; 4 ``dh`` per live (query, key)
pair per query head for attention; the SSM mixer's depthwise conv and the
chunked SSD scan's causal half.  Training is three times the forward (the backward
twice); recomputation for remat and padded expert slots are not work.
"""
from __future__ import annotations

from bench.harness.work import Pass, layer_windows, live_pairs, ssd_dims, \
    ssd_ops


def layer_matmul_flops_per_token(cfg: dict) -> float:
    d, dh = cfg["d_model"], cfg["d_head"]
    hq, hkv = cfg["n_heads"], cfg["n_kv_heads"]
    attn = 2 * d * (hq + 2 * hkv) * dh + 2 * hq * dh * d
    if cfg["family"] == "moe":
        ff = 2 * d * cfg["n_experts"] + (cfg["top_k"] + cfg.get(
            "n_shared_experts", 0)) * 2 * 3 * d * cfg["d_ff"]
    else:
        ff = 2 * 3 * d * cfg["d_ff"]
    mixer = 0
    dims = ssd_dims(cfg)
    if dims is not None:
        nh, _, ds, g = dims
        di = cfg["ssm_expand"] * d
        mixer = 2 * d * (2 * di + 2 * g * ds + nh) + 2 * di * d
    return float(attn + ff + mixer)


def matmul_flops(cfg: dict, p: Pass) -> float:
    """Forward FLOPs of the dense products (the unembedding included)."""
    return (cfg["n_layers"] * p.b * p.s * layer_matmul_flops_per_token(cfg)
            + 2.0 * p.logits_rows * cfg["d_model"] * cfg["vocab_size"])


def attention_flops(cfg: dict, p: Pass) -> float:
    dh, hq = cfg["d_head"], cfg["n_heads"]
    return float(sum(4 * dh * hq * p.b * live_pairs(p.s, p.s, True, w)
                     for w in layer_windows(cfg)))


def scan_flops(cfg: dict, p: Pass) -> float:
    """The SSM mixer's depthwise conv (2 per tap) and SSD scan."""
    dims = ssd_dims(cfg)
    if dims is None:
        return 0.0
    nh, dh, ds, g = dims
    conv = 2 * cfg["conv_width"] * (cfg["ssm_expand"] * cfg["d_model"]
                                    + 2 * g * ds) * p.b * p.s
    return cfg["n_layers"] * (conv + ssd_ops(p.b, p.s, nh, dh, ds, g))


def forward_flops(cfg: dict, p: Pass) -> float:
    return matmul_flops(cfg, p) + attention_flops(cfg, p) + scan_flops(cfg, p)


def model_flops(cfg: dict, p: Pass) -> float:
    """The pass's model FLOPs: the forward, three times in training."""
    return (3.0 if p.backward else 1.0) * forward_flops(cfg, p)

"""The work a pass of the model requires, counted from its shapes: the
algorithm's operations, the same whatever kernel computes them.

A ``Pass`` is one forward (and, in training, backward) of ``b`` sequences
of ``s`` tokens; the per-kernel counts here are what the roofline metrics
(``bench/metrics``) and the model FLOPs (``bench/configs/model_flops.py``)
build on.
"""
from __future__ import annotations

import dataclasses
import functools

#: The SSD scan's chunk (the program's and the reference's).
SSD_CHUNK = 128


@dataclasses.dataclass(frozen=True)
class Pass:
    b: int                 # sequences
    s: int                 # tokens each
    logits_rows: int       # rows whose logits are computed (b s, or b)
    backward: bool         # training: the backward too


@functools.lru_cache(maxsize=None)
def live_pairs(sq: int, skv: int, causal: bool = True, window=None,
               q_offset: int = 0) -> int:
    """(query, key) pairs a causal / windowed mask leaves visible, query
    rows at kv positions ``q_offset ..``; a key is visible to query q when
    ``q - window < k <= q``."""
    total = 0
    for qpos in range(q_offset, q_offset + sq):
        hi = min(qpos, skv - 1) if causal else skv - 1
        lo = max(0, qpos - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def layer_windows(cfg: dict) -> list:
    """Each layer's attention window (None: full causal)."""
    glob = set(cfg.get("global_layers") or ())
    return [None if (cfg["family"] == "hybrid" and i in glob)
            else cfg.get("window") for i in range(cfg["n_layers"])]


def ssd_dims(cfg: dict) -> tuple[int, int, int, int] | None:
    """``(heads, head width, state, groups)`` of the SSD scan, or None."""
    if cfg["family"] not in ("hybrid", "ssm"):
        return None
    nh = cfg["ssm_expand"] * cfg["d_model"] // cfg["ssm_head_dim"]
    return nh, cfg["ssm_head_dim"], cfg["ssm_state"], cfg["ssm_groups"]


def _chunks(s: int, chunk: int):
    return [min(chunk, s - c0) for c0 in range(0, s, chunk)]


def ssd_ops(b: int, s: int, nh: int, dh: int, ds: int, g: int,
            chunk: int = SSD_CHUNK) -> float:
    """f32 operations of the chunked scan, counting only the causal half of
    the two (L, L) products over L(L+1)/2 pairs: per chunk and group
    G = C B^T, which depends on a head only through its group; per chunk
    and head (G * decay) x, one exp per pair, the inter-chunk output and
    the state update (2 L dh ds each)."""
    total = 0
    for n in _chunks(s, chunk):
        pairs = n * (n + 1) // 2
        total += g * 2 * pairs * ds \
            + nh * (2 * pairs * dh + pairs + 4 * n * dh * ds)
    return float(b * total)


def ssd_bwd_ops(b: int, s: int, nh: int, dh: int, ds: int, g: int,
                chunk: int = SSD_CHUNK) -> float:
    """Multiply-add operations of the scan's gradient over the causal
    (t, j) pairs: per chunk and head 2 dh per pair twice (P = dy x^T and
    dx) and 8 L dh ds for the state terms; per chunk and group 3 ds per
    pair twice (G = C B^T, dB, dC), once per group since they depend on a
    head only through the group's sum."""
    total = 0
    for n in _chunks(s, chunk):
        pairs = n * (n + 1) // 2
        total += nh * (2 * pairs * 2 * dh + 8 * n * dh * ds) \
            + g * 2 * pairs * 3 * ds
    return float(b * total)

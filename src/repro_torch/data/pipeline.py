"""Deterministic, shard-aware, checkpoint-resumable LM token pipeline.

Counterpart of ``repro/data/pipeline.py``, numpy on the host, giving the
reference's tokens bit for bit (the same ``RandomState`` seeding and
draws):

* **Stateless indexing**: batch ``t`` is a pure function of (seed, step t,
  host shard), so resuming from a checkpoint at step t replays the exact
  token stream with no pipeline state beyond the step counter.
* **Shard awareness**: each data-parallel host slice draws a disjoint row
  range of the global batch (``host_index`` / ``host_count``).
* **Skip-ahead**: ``batch_at`` for any future step is O(1).

The corpus is the reference's synthetic-but-structured source (Zipfian
unigrams + copied n-grams, so LM losses fall during a run).

``TokenPipeline.device_batch_at`` brings a step's batch to the card in one
pinned, non-blocking copy of its ``(host_batch, seq_len + 1)`` token rows;
``tokens`` and ``labels`` are views of that one device tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.host_count:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.host_count} hosts")
        return self.global_batch // self.host_count


class TokenSource:
    """Synthetic corpus: Zipf unigrams + copied n-grams => learnable
    structure."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seed = seed
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._p = p / p.sum()

    def sequence(self, idx: int, length: int) -> np.ndarray:
        """Deterministic sequence of ``length + 1`` tokens for document
        ``idx``."""
        rng = np.random.RandomState((self.seed * 1_000_003 + idx) % (2**31 - 1))
        toks = rng.choice(self.vocab_size, size=length + 1, p=self._p)
        # plant copy structure: periodic repeats of a window (induction heads
        # and SSM state both learn this => losses drop visibly)
        period = min(64 + (idx % 64), max(len(toks) // 2, 1))
        if len(toks) > period:
            toks[period:] = np.where(
                rng.rand(len(toks) - period) < 0.5,
                toks[:-period], toks[period:]
            )
        return toks.astype(np.int32)


@dataclasses.dataclass
class TokenPipeline:
    cfg: PipelineConfig

    def __post_init__(self):
        self._source = TokenSource(self.cfg.vocab_size, self.cfg.seed)

    def rows_at(self, step: int) -> np.ndarray:
        """The host's ``(host_batch, seq_len + 1)`` int32 token rows of
        global step ``step``."""
        c = self.cfg
        row0 = step * c.global_batch + c.host_index * c.host_batch
        return np.stack([self._source.sequence(row0 + r, c.seq_len)
                         for r in range(c.host_batch)])

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Host-local batch for global step ``step``: pure function, O(1)
        seek."""
        seqs = self.rows_at(step)
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}

    def device_batch_at(self, step: int, device) -> dict[str, torch.Tensor]:
        """``batch_at(step)`` on ``device``: one pinned, non-blocking copy
        to a card (a plain copy to the CPU)."""
        dev = torch.device(device)
        rows = torch.from_numpy(self.rows_at(step))
        if dev.type == "cuda":
            rows = rows.pin_memory().to(dev, non_blocking=True)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

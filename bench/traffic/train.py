"""Traffic of kind ``train``: a training job's token rows, step by step.

Step ``t`` takes documents ``t * global_batch + r`` of the corpus, so no
two rows of a run are alike, and a step's rows are a pure function of the
seed and ``t``.  The program receives only these rows, as ``tokens`` and
``labels`` (the rows shifted by one) on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.harness.corpus import TokenSource


class Feed:
    def __init__(self, mix: dict, cfg: dict, seed: int):
        self.mix = mix
        self.source = TokenSource(cfg["vocab_size"], seed, mix["corpus"])

    @property
    def tokens_per_step(self) -> int:
        return self.mix["global_batch"] * self.mix["seq_len"]

    def rows(self, step: int) -> np.ndarray:
        """``(global_batch, seq_len + 1)`` int32 rows of step ``step``."""
        b, s = self.mix["global_batch"], self.mix["seq_len"]
        return np.stack([self.source.sequence(step * b + r, s)
                         for r in range(b)])

    def batch(self, step: int, device) -> dict:
        """Step ``step``'s ``tokens`` and ``labels`` on ``device``: one
        pinned, non-blocking copy of the rows to a card."""
        rows = torch.from_numpy(self.rows(step))
        if torch.device(device).type == "cuda":
            rows = rows.pin_memory().to(device, non_blocking=True)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

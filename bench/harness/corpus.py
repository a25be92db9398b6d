"""The token source of every LM traffic mix: Zipf unigrams with copied
n-grams, one document per index, drawn from the run's seed alone.

A copy of the port's ``data/pipeline.py::TokenSource`` (the reference's
synthetic corpus), kept here so that the yardstick does not move when the
program does.  The mix file's ``corpus`` block sets its parameters.
"""
from __future__ import annotations

import numpy as np


class TokenSource:
    """Document ``idx`` of ``length + 1`` tokens: Zipf(``zipf_exponent``)
    unigrams over the vocabulary, then, past a period of ``period_base +
    idx % period_span`` tokens, each token replaced by the one a period
    back with probability ``copy_share`` (structure that induction heads and
    SSM state both learn)."""

    def __init__(self, vocab_size: int, seed: int, corpus: dict):
        self.vocab_size = vocab_size
        self.seed = int(seed)
        self.corpus = corpus
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** corpus["zipf_exponent"]
        self._p = p / p.sum()

    def sequence(self, idx: int, length: int) -> np.ndarray:
        c = self.corpus
        rng = np.random.RandomState((self.seed * 1_000_003 + idx)
                                    % (2 ** 31 - 1))
        toks = rng.choice(self.vocab_size, size=length + 1, p=self._p)
        period = min(c["period_base"] + idx % c["period_span"],
                     max(len(toks) // 2, 1))
        if len(toks) > period:
            toks[period:] = np.where(
                rng.rand(len(toks) - period) < c["copy_share"],
                toks[:-period], toks[period:])
        return toks.astype(np.int32)

"""Traffic of kind ``prefill``: a closed-loop client's prompt batches.

One cycle holds ``count`` requests of each ``[length, count]`` of the mix,
in an order drawn from the seed; each request is ``batch`` prompts of its
length, documents of the corpus that no other request of the cycle shares.
Every seed sends the same set of sizes, so seeds change the order and the
tokens, not the work.  The client sends the cycle again and again.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from bench.harness.corpus import TokenSource


@dataclasses.dataclass(frozen=True)
class Request:
    length: int
    rows: np.ndarray            # (batch, length) int32 prompt tokens


def cycle(mix: dict, cfg: dict, seed: int) -> list[Request]:
    lengths = [n for n, count in mix["lengths"] for _ in range(count)]
    order = np.random.RandomState(int(seed) % (2 ** 32)).permutation(
        len(lengths))
    source = TokenSource(cfg["vocab_size"], seed, mix["corpus"])
    b = mix["batch"]
    return [Request(lengths[j], np.stack([
        source.sequence(i * b + r, lengths[j])[:-1] for r in range(b)]))
        for i, j in enumerate(order)]


def sample(mix: dict, requests: list[Request], seed: int) -> list[int]:
    """The requests of the first cycle whose outputs are compared: one of
    the longest (drawn from the seed) and ``sample - 1`` others."""
    rng = np.random.RandomState((int(seed) + 1) % (2 ** 32))
    longest = max(r.length for r in requests)
    first = rng.choice([i for i, r in enumerate(requests)
                        if r.length == longest])
    rest = [i for i in range(len(requests)) if i != first]
    picked = rng.choice(rest, size=min(len(rest), mix["sample"] - 1),
                        replace=False)
    return sorted([int(first), *map(int, picked)])

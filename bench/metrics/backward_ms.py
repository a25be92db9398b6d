"""``backward_ms.<kind>`` (ms per step): the busy device time of the
operations launched inside the program's ``train.backward`` spans, each
microbatch's ``loss.backward()`` with remat's recompute
(``bench/harness/spans.py``); none where the program marks no such span."""
from __future__ import annotations

from bench.harness.spans import phase_ms


def read(ctx):
    return phase_ms(ctx, "train.backward")

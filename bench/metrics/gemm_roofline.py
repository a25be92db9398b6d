"""``gemm_roofline.<kind>`` (%): the dense layers' least time on the chip
over the device time of the GEMM kernels (cuBLAS, through ``F.linear``,
``einsum`` and ``bmm``).

The work is the configuration's dense products
(``model_flops.matmul_flops``: the active experts only, the unembedding
of the rows whose logits are computed), three times the forward in
training, against the bf16 tensor-core peak."""
from __future__ import annotations

from bench.configs.model_flops import matmul_flops

#: Substrings of the names of cuBLAS's GEMM kernels on Hopper.
MARKS = ("gemm", "gemv", "nvjet", "splitkreduce")


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in MARKS)


def read(ctx):
    t = ctx.trace.device_seconds(is_gemm) if ctx.trace else 0.0
    if t <= 0 or ctx.peaks is None:
        return None
    flops = sum((3.0 if p.backward else 1.0) * matmul_flops(ctx.config, p)
                for p in ctx.traced)
    return 100.0 * flops / ctx.peaks["bf16"] / t

"""Serving substrate of the port.

Two engines live here: the LM prefill/decode substrate (``engine``) and
the SVM fleet streaming engine (``svm_engine``): micro-batched,
padding-bucketed, multi-model co-batched serving of compiled SVM fleets,
with deadline/priority continuous batching, admission control and
mesh-sharded dispatch.
"""
from repro_torch.serving import engine  # noqa: F401
from repro_torch.serving.svm_engine import (  # noqa: F401
    BucketPolicy,
    ServingStats,
    ShedError,
    SVMEngine,
)

"""``moe_dispatch_ms.<kind>`` (ms per step or per request): device time in
PyTorch's gather, index, scatter, sort and top-k kernels, the MoE
dispatch of ``models/mlp.py`` (its token gather and that gather's
backward, the sort by expert, the scatter-add back to the tokens).  The
embedding lookup and the loss's label gather run kernels of the same
names and are counted with it: one call each per microbatch against the
dispatch's one per layer."""
from __future__ import annotations

#: Base names (``trace.base_name``) of PyTorch's CUDA kernels for these
#: operations.
PREFIXES = ("index_elementwise_kernel", "indexing_backward_kernel",
            "_scatter_gather_elementwise_kernel", "indexFuncLargeIndex",
            "indexFuncSmallIndex", "indexSelectLargeIndex",
            "indexSelectSmallIndex", "DeviceRadixSort",
            "DeviceSegmentedRadixSort", "radixSortKVInPlace",
            "bitonicSortKVInPlace", "sort_postprocess_kernel",
            "fill_index_and_segment_kernel", "gatherTopK",
            "computeBlockwiseWithinKCounts", "computeBlockwiseKthCounts",
            "computeDigitCumSum", "radixFindKthValues")


def read(ctx):
    if ctx.config["family"] != "moe" or ctx.trace is None \
            or not ctx.traced_items:
        return None
    s = ctx.trace.prefix_seconds(PREFIXES)
    return 1e3 * s / ctx.traced_items if s > 0 else None

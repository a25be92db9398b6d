"""Mixed-precision domain assignment — the accelerator analogue of "mixed-signal".

Counterpart of ``repro/core/mixed_precision.py``.  The paper's domain split
(approximate-analog vs exact-digital) maps to precision domains: int8
("analog" — cheap, approximate) vs bf16/fp32 ("digital" — exact).
Algorithm 1's separation-driven strategy transfers unchanged, at *module*
granularity:

    for each module m:
        quality_cheap  = quality(model with m in the cheap domain)
        quality_exact  = quality(model with m in the exact domain)
        assign m to cheap unless the exact domain is strictly better by
        more than `tolerance`

i.e. exactly the paper's "keep RBF only where it buys accuracy", inverted:
keep high precision only where it buys quality.

Also provides the int8 quantized-weight container (``QuantTensor``).
``quantize_tree_where`` takes a tree of tensors (the reference's layout)
or the port's model: on a model it walks ``named_parameters`` and asks
``domain_of_path`` with the reference's key tuples
(``convert.reference_leaves``: ``("layers", "attn", "wq", "w")``), so one
routing function serves both packages, and quantizes each weight in the
reference's orientation (``(d_in, d_out)``, channels on the last axis), so
its codes are the reference's, layer by layer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
from torch import nn


@dataclasses.dataclass
class QuantTensor:
    """Symmetric per-channel int8 weight: w ~= q * scale (scale per last dim)."""

    q: torch.Tensor       # int8, same shape as w
    scale: torch.Tensor   # (..., 1) broadcastable f32

    @classmethod
    def quantize(cls, w: torch.Tensor, axis: int = -1) -> "QuantTensor":
        amax = torch.clamp(w.abs().amax(dim=axis, keepdim=True), min=1e-8)
        # divided elementwise: a CUDA division by a Python number multiplies
        # by its reciprocal, an ulp off the CPU's quotient at times
        scale = amax / torch.full_like(amax, 127.0)
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        return cls(q=q, scale=scale.float())

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)

    @property
    def nbytes(self) -> int:
        return self.q.numel() + self.scale.numel() * 4


def dequant_matmul(x: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """x @ dequant(w), w in the reference's ``(d_in, d_out)`` layout."""
    return x @ w.dequantize(x.dtype)


# ---------------------------------------------------------------------------
# Separation-driven domain assignment (Algorithm 1, precision edition)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DomainAssignment:
    modules: list[str]
    domain: dict[str, str]            # module -> 'cheap' | 'exact'
    quality_cheap: dict[str, float]
    quality_exact: dict[str, float]

    @property
    def n_cheap(self) -> int:
        return sum(v == "cheap" for v in self.domain.values())


def assign_domains(
    modules: Sequence[str],
    quality_with_domains: Callable[[dict[str, str]], float],
    tolerance: float = 0.0,
) -> DomainAssignment:
    """Per-module greedy separation, mirroring Algorithm 1's per-pair loop.

    ``quality_with_domains`` evaluates the end-to-end model quality (higher
    is better — accuracy, or -perplexity) under a full module->domain map.
    Each module is probed independently against the all-exact reference
    (the analogue of training both kernels per pair), then the joint cheap
    assignment keeps every module whose independent probe showed no loss
    beyond ``tolerance``.
    """
    base = {m: "exact" for m in modules}
    q_exact_all = quality_with_domains(dict(base))
    q_cheap: dict[str, float] = {}
    q_exact: dict[str, float] = {}
    domain: dict[str, str] = {}
    for m in modules:
        probe = dict(base)
        probe[m] = "cheap"
        q_cheap[m] = quality_with_domains(probe)
        q_exact[m] = q_exact_all
        # keep exact ONLY if it is strictly better beyond tolerance
        domain[m] = "exact" if (q_exact_all - q_cheap[m]) > tolerance else "cheap"
    return DomainAssignment(
        modules=list(modules), domain=domain,
        quality_cheap=q_cheap, quality_exact=q_exact,
    )


def _cheap(t: torch.Tensor, ndim: int, domain: str) -> bool:
    return ndim >= 2 and t.is_floating_point() and domain == "cheap"


def quantize_tree_where(params, domain_of_path: Callable[[tuple], str]):
    """Quantize leaves whose tree path maps to the 'cheap' domain.

    2-D+ float leaves in cheap modules become QuantTensor; everything else
    passes through.  Embedding/norm params should be routed 'exact' by the
    caller's ``domain_of_path``.  ``params``: a tree (nested dicts / lists
    of tensors) -> the same tree; or the port's model -> ``{parameter
    name: QuantTensor or tensor}``, routed by the reference's leaf paths
    (a stacked leaf's dims decide, as there).
    """
    if isinstance(params, nn.Module):
        from repro_torch.models import convert

        names = {id(t): n for n, t in params.named_parameters()}
        out = {}
        for leaf in convert.reference_leaves(None, params):
            domain = domain_of_path(leaf.path)
            for t in leaf.tensors:
                out[names[id(t)]] = QuantTensor.quantize(
                    leaf._part(t.detach())) if _cheap(
                        t, len(leaf.shape), domain) else t
        return out

    def walk(tree, key: tuple):
        if isinstance(tree, dict):
            return {k: walk(v, key + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, key + (i,)) for i, v in enumerate(tree))
        if isinstance(tree, torch.Tensor) and _cheap(
                tree, tree.ndim, domain_of_path(key)):
            return QuantTensor.quantize(tree)
        return tree

    return walk(params, ())


def _leaves(tree):
    if isinstance(tree, nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_param_bytes(params) -> int:
    """Total parameter bytes, QuantTensor-aware (for roofline accounting)."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QuantTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes"):
            total += leaf.nbytes
    return total

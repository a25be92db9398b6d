"""Model assembly for the hybrid family (hymba).

Counterpart of ``repro/models/transformer.py``.  A hybrid block runs
parallel attention and Mamba2 heads on one pre-norm input, mean-combines
them into the residual stream, then a gated MLP; attention uses a sliding
window except in ``cfg.global_layers``.

The reference scans a stacked layer tree with the per-layer window as a
traced value (2**30 for global layers).  The port loops over an
``nn.ModuleList`` in Python and resolves each layer's window there:
``None`` for a global layer, ``cfg.window`` otherwise, so the attention
kernel (K3) skips the kv blocks a window hides.  The other families (dense
/ moe / ssm / vlm / audio) are not ported yet and raise.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    ModelConfig, Norm, dense_apply, normal, norm_apply, norm_init,
)

PORTED_FAMILIES = ("hybrid",)


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; ported: "
            f"{PORTED_FAMILIES}")


class Block(nn.Module):
    """One hybrid layer: ``norm1``, ``attn``, ``ssm``, ``norm2``, ``mlp``."""

    def __init__(self, norm1: Norm, attn_p: attn.Attention, ssm_p: ssm_mod.SSM,
                 norm2: Norm, mlp_p: mlp_mod.MLP):
        super().__init__()
        self.norm1, self.attn, self.ssm = norm1, attn_p, ssm_p
        self.norm2, self.mlp = norm2, mlp_p


class Transformer(nn.Module):
    """``embed (V, D)``, ``layers``, ``final_norm`` and ``unembed (V, D)``
    (absent when the embeddings are tied)."""

    def __init__(self, embed: torch.Tensor, layers: list[Block],
                 final_norm: Norm, unembed: torch.Tensor | None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.unembed = (None if unembed is None
                        else nn.Parameter(unembed, requires_grad=False))


def _init_block(cfg: ModelConfig, generator: torch.Generator, dtype) -> Block:
    dev = generator.device
    return Block(norm_init(cfg, cfg.d_model, dev),
                 attn.init(cfg, generator, dtype),
                 ssm_mod.init(cfg, generator, dtype),
                 norm_init(cfg, cfg.d_model, dev),
                 mlp_mod.init_dense(cfg, generator, dtype=dtype))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype | None = None) -> Transformer:
    """Random init with the reference's scales and distributions, drawn from
    ``generator`` on its device (a CUDA generator draws on the card).  Dense
    weights and embeddings are stored in ``dtype`` (default: the config's
    compute dtype); norms, the conv kernel and the SSM vectors in f32.  The
    stream differs from the reference's ``jax.random`` draws."""
    _require_ported(cfg)
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.vocab_size, cfg.d_model)
    embed = normal(shape, 0.02, generator, dtype)
    unembed = None if cfg.tie_embeddings else normal(shape, 0.02, generator,
                                                     dtype)
    layers = [_init_block(cfg, generator, dtype) for _ in range(cfg.n_layers)]
    return Transformer(embed, layers,
                       norm_init(cfg, cfg.d_model, generator.device), unembed)


# ---------------------------------------------------------------------------
# Blocks (full-sequence path)
# ---------------------------------------------------------------------------


def block_forward(cfg: ModelConfig, p: Block, x: torch.Tensor,
                  positions: torch.Tensor, is_global: bool):
    """One hybrid layer, full sequence, causal.  Returns (x, aux) with aux
    carrying the layer's (k, v) and SSM state for prefill."""
    _require_ported(cfg)
    window = None if is_global else cfg.window
    h = norm_apply(cfg, x, p.norm1)
    q, k, v = attn.qkv(cfg, p.attn, h, positions)
    a_out = attn.attend(cfg, q, k, v, window=window)
    b, hq, s, dh = a_out.shape
    a_out = dense_apply(p.attn.wo, a_out.transpose(1, 2).reshape(b, s, hq * dh))
    y, state = ssm_mod.apply_seq(cfg, p.ssm, h)
    x = x + 0.5 * (a_out + y)            # parallel heads, mean-combined
    x = x + mlp_mod.apply_dense(cfg, p.mlp, norm_apply(cfg, x, p.norm2))
    return x, {"kv": (k, v), "ssm": state}


def run_stack(cfg: ModelConfig, layers: nn.ModuleList, x: torch.Tensor,
              positions: torch.Tensor):
    """The layers in order.  Returns (x, per-layer aux list) for prefill."""
    kept = []
    for i, p in enumerate(layers):
        x, aux = block_forward(cfg, p, x, positions,
                               is_global=i in cfg.global_layers)
        kept.append(aux)
    return x, kept


# ---------------------------------------------------------------------------
# Embedding and logits
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor
                 ) -> torch.Tensor:
    return params.embed[tokens].to(cfg.compute_dtype)


def logits_from_x(cfg: ModelConfig, params: Transformer, x: torch.Tensor
                  ) -> torch.Tensor:
    x = norm_apply(cfg, x, params.final_norm)
    unembed = params.embed if params.unembed is None else params.unembed
    logits = x @ unembed.to(x.dtype).T
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits

"""Model assembly for every architecture family of the reference.

Counterpart of ``repro/models/transformer.py``.  Families:

  dense / vlm      pre-norm GQA + gated MLP (parallel block for command-r:
                   ``x + attn(norm1 x) + mlp(norm1 x)``)
  moe              GQA + sort-based capacity MoE (+ shared experts)
  ssm              Mamba2 mixer only (``norm1`` + ``ssm``)
  hybrid (hymba)   parallel attn & mamba heads sharing the residual stream,
                   SWA everywhere except cfg.global_layers
  audio (whisper)  encoder (non-causal) + decoder (causal + cross-attn)

The vlm / audio modality frontends are stubs, as in the reference: inputs
arrive as precomputed patch / frame embeddings of width d_model.

The reference scans a stacked layer tree (for hymba with the per-layer
window as a traced value, 2**30 for global layers).  The port loops over an
``nn.ModuleList`` in Python and resolves each layer's window there: ``None``
for a global layer, ``cfg.window`` otherwise, so the attention kernel (K3)
skips the kv blocks a window hides.  ``use_scan_attention`` (the port has
one attention path) is not read.

Training (``forward_train``, ``softmax_xent``) reads ``cfg.remat`` per
block, as the reference's ``_remat`` wraps its scanned body: ``"none"``
keeps every activation; ``"dots"`` saves the outputs of the dense products
(``aten.mm`` / ``aten.addmm``, JAX's ``dots_with_no_batch_dims_saveable``:
the batched expert and attention products are recomputed); anything else
(``"full"``, the configs' default) keeps only each block's input and
recomputes the block, K3 included, in the backward.  Remat applies only
where a graph is built: serving runs the same stacks with no checkpoint.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    ModelConfig, Norm, dense_apply, normal, norm_apply, norm_init,
)


class Block(nn.Module):
    """One layer.  Submodules carry the reference's tree keys; those a
    family lacks are None:

      dense / vlm (and the audio encoder)  norm1, attn, norm2, mlp
      moe                                  norm1, attn, norm2, moe
      ssm                                  norm1, ssm
      hybrid                               norm1, attn, ssm, norm2, mlp
      audio decoder                        norm1, attn, norm_x, xattn,
                                           norm2, mlp
    """

    def __init__(self, norm1: Norm, attn: attn.Attention | None = None,
                 norm2: Norm | None = None, mlp: mlp_mod.MLP | None = None,
                 moe: mlp_mod.MoE | None = None,
                 ssm: ssm_mod.SSM | None = None, norm_x: Norm | None = None,
                 xattn: attn.Attention | None = None):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.mlp = norm1, attn, norm2, mlp
        self.moe, self.ssm, self.norm_x, self.xattn = moe, ssm, norm_x, xattn


class Transformer(nn.Module):
    """``embed (V, D)``, ``layers``, ``final_norm``, ``unembed (V, D)``
    (None when the embeddings are tied) and, for the audio family, the
    encoder's ``enc_layers`` and ``enc_norm`` (None otherwise)."""

    def __init__(self, embed: torch.Tensor, layers: list[Block],
                 final_norm: Norm, unembed: torch.Tensor | None,
                 enc_layers: list[Block] | None = None,
                 enc_norm: Norm | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.unembed = (None if unembed is None
                        else nn.Parameter(unembed, requires_grad=False))
        self.enc_layers = None if enc_layers is None else nn.ModuleList(
            enc_layers)
        self.enc_norm = enc_norm


def _init_block(cfg: ModelConfig, generator: torch.Generator, dtype,
                cross: bool = False) -> Block:
    dev, fam, d = generator.device, cfg.family, cfg.d_model
    kw = {"norm1": norm_init(cfg, d, dev)}
    if fam != "ssm":
        kw["attn"] = attn.init(cfg, generator, dtype)
        kw["norm2"] = norm_init(cfg, d, dev)
    if fam == "moe":
        kw["moe"] = mlp_mod.init_moe(cfg, generator, dtype)
    elif fam != "ssm":
        kw["mlp"] = mlp_mod.init_dense(cfg, generator, dtype=dtype)
    if fam in ("ssm", "hybrid"):
        kw["ssm"] = ssm_mod.init(cfg, generator, dtype)
    if cross:
        kw["norm_x"] = norm_init(cfg, d, dev)
        kw["xattn"] = attn.init(cfg, generator, dtype)
    return Block(**kw)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype | None = None) -> Transformer:
    """Random init with the reference's scales and distributions, drawn from
    ``generator`` on its device (a CUDA generator draws on the card).  Dense
    weights, expert weights and embeddings are stored in ``dtype`` (default:
    the config's compute dtype); norms, the router, the conv kernel and the
    SSM vectors in f32.  The stream differs from the reference's
    ``jax.random`` draws."""
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.vocab_size, cfg.d_model)
    embed = normal(shape, 0.02, generator, dtype)
    unembed = None if cfg.tie_embeddings else normal(shape, 0.02, generator,
                                                     dtype)
    audio = cfg.family == "audio"
    layers = [_init_block(cfg, generator, dtype, cross=audio)
              for _ in range(cfg.n_layers)]
    enc_layers = enc_norm = None
    if audio:
        enc = dataclasses.replace(cfg, family="dense")
        enc_layers = [_init_block(enc, generator, dtype)
                      for _ in range(cfg.n_enc_layers)]
        enc_norm = norm_init(cfg, cfg.d_model, generator.device)
    return Transformer(embed, layers,
                       norm_init(cfg, cfg.d_model, generator.device), unembed,
                       enc_layers, enc_norm)


# ---------------------------------------------------------------------------
# Blocks (full-sequence path)
# ---------------------------------------------------------------------------


def _self_attention(cfg: ModelConfig, p: Block, h: torch.Tensor,
                    positions: torch.Tensor, causal: bool, window):
    """wo(attend(qkv(h))) and the layer's (k, v)."""
    q, k, v = attn.qkv(cfg, p.attn, h, positions)
    out = attn.attend(cfg, q, k, v, causal=causal, window=window)
    return dense_apply(p.attn.wo, attn.merge_heads(out)), (k, v)


def block_forward(cfg: ModelConfig, p: Block, x: torch.Tensor,
                  positions: torch.Tensor, is_global: bool = False,
                  causal: bool = True):
    """One layer, full sequence.  Returns (x, aux) with aux carrying the
    layer's (k, v) and / or SSM state for prefill, and the MoE aux loss."""
    aux: dict = {}
    fam = cfg.family
    if fam in ("dense", "vlm", "moe", "audio"):
        h = norm_apply(cfg, x, p.norm1)
        a_out, aux["kv"] = _self_attention(cfg, p, h, positions, causal,
                                           cfg.window)
        if cfg.parallel_block:
            x = x + a_out + mlp_mod.apply_dense(cfg, p.mlp, h)
        else:
            x = x + a_out
            h = norm_apply(cfg, x, p.norm2)
            if fam == "moe":
                m_out, aux["moe_aux"] = mlp_mod.apply_moe(cfg, p.moe, h)
            else:
                m_out = mlp_mod.apply_dense(cfg, p.mlp, h)
            x = x + m_out
    elif fam == "ssm":
        y, aux["ssm"] = ssm_mod.apply_seq(cfg, p.ssm,
                                          norm_apply(cfg, x, p.norm1))
        x = x + y
    elif fam == "hybrid":
        h = norm_apply(cfg, x, p.norm1)
        a_out, aux["kv"] = _self_attention(
            cfg, p, h, positions, True, None if is_global else cfg.window)
        y, aux["ssm"] = ssm_mod.apply_seq(cfg, p.ssm, h)
        x = x + 0.5 * (a_out + y)            # parallel heads, mean-combined
        x = x + mlp_mod.apply_dense(cfg, p.mlp, norm_apply(cfg, x, p.norm2))
    else:
        raise ValueError(f"unknown family {fam!r}")
    return x, aux


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs of
    the dense (unbatched) products, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn, p: nn.Module, x: torch.Tensor):
    """``fn`` under the config's activation checkpointing where a graph is
    built through the block (grad mode on, and ``x`` or a parameter of
    ``p`` requires a gradient); ``fn`` itself otherwise."""
    if cfg.remat == "none" or not torch.is_grad_enabled() or not (
            x.requires_grad or any(t.requires_grad for t in p.parameters())):
        return fn
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    return functools.partial(checkpoint, fn, use_reentrant=False)


def run_stack(cfg: ModelConfig, layers: nn.ModuleList, x: torch.Tensor,
              positions: torch.Tensor, causal: bool = True):
    """The layers in order (each under ``cfg.remat`` when training).
    Returns (x, per-layer aux list): kv / SSM state for prefill, the MoE
    aux loss for training."""
    kept = []
    for i, p in enumerate(layers):
        x, aux = _remat(cfg, block_forward, p, x)(
            cfg, p, x, positions, is_global=i in cfg.global_layers,
            causal=causal)
        kept.append(aux)
    return x, kept


# ---------------------------------------------------------------------------
# Embedding, logits and the whisper encoder / decoder
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


def encode_audio(cfg: ModelConfig, params: Transformer,
                 frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, Se, D): dense blocks
    with non-causal attention (K3), then ``enc_norm``."""
    enc_cfg = dataclasses.replace(cfg, family="dense",
                                  n_layers=cfg.n_enc_layers)
    x = frames.to(cfg.compute_dtype)
    pos = torch.arange(frames.shape[1], device=x.device)
    x, _ = run_stack(enc_cfg, params.enc_layers, x, pos, causal=False)
    return norm_apply(cfg, x, params.enc_norm)


def run_dec_stack_audio(cfg: ModelConfig, params: Transformer,
                        x: torch.Tensor, positions: torch.Tensor,
                        enc_out: torch.Tensor):
    """Whisper decoder stack: causal self-attention, cross-attention to the
    encoder output (non-causal, Se keys, no rope on them; q is roped at
    ``positions``, as the reference's ``qkv`` does), gated MLP.  Returns
    (x, per-layer {"kv": self (k, v), "xkv": cross (k, v)})."""
    kept = []
    for p in params.layers:
        x, aux = _remat(cfg, _dec_block_audio, p, x)(cfg, p, x, positions,
                                                     enc_out)
        kept.append(aux)
    return x, kept


def _dec_block_audio(cfg: ModelConfig, p: Block, x: torch.Tensor,
                     positions: torch.Tensor, enc_out: torch.Tensor):
    """One whisper decoder block -> (x, {"kv", "xkv"})."""
    a_out, kv = _self_attention(cfg, p, norm_apply(cfg, x, p.norm1),
                                positions, True, cfg.window)
    x = x + a_out
    q = attn.query(cfg, p.xattn, norm_apply(cfg, x, p.norm_x), positions)
    kx, vx = attn.kv_of(cfg, p.xattn, enc_out)
    out = attn.attend(cfg, q, kx, vx, causal=False)
    x = x + dense_apply(p.xattn.wo, attn.merge_heads(out))
    x = x + mlp_mod.apply_dense(cfg, p.mlp, norm_apply(cfg, x, p.norm2))
    return x, {"kv": kv, "xkv": (kx, vx)}


# ---------------------------------------------------------------------------
# Training: the token-level loss of every family
# ---------------------------------------------------------------------------


def forward_train(cfg: ModelConfig, params: Transformer, batch: dict
                  ) -> tuple[torch.Tensor, dict]:
    """Token-level LM loss (+ aux) of every family -> ``(loss, metrics)``.

    ``batch``: ``tokens`` and ``labels`` (b, s) int; the vlm family may add
    ``patch_embeds`` (b, n_patches, d), prepended to the tokens and cut off
    before the logits; whisper reads ``frames`` (b, se, d) through its
    encoder.  The MoE's aux loss is summed over the layers into the loss.
    """
    if cfg.family == "audio":
        enc_out = encode_audio(cfg, params, batch["frames"])
        x = embed_tokens(cfg, params, batch["tokens"])
        pos = torch.arange(batch["tokens"].shape[1], device=x.device)
        x, kept = run_dec_stack_audio(cfg, params, x, pos, enc_out)
    else:
        x = embed_tokens(cfg, params, batch["tokens"])
        patches = batch.get("patch_embeds") if cfg.family == "vlm" else None
        if patches is not None:
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        x, kept = run_stack(cfg, params.layers, x, pos)
        if patches is not None:
            x = x[:, patches.shape[1]:]

    logits = logits_from_x(cfg, params, x)
    loss, metrics = softmax_xent(logits, batch["labels"])
    if cfg.family == "moe":
        aux = torch.stack([a["moe_aux"] for a in kept]).sum()
        loss = loss + aux
        metrics["moe_aux"] = aux
    return loss, metrics


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_coef: float = 1e-4) -> tuple[torch.Tensor, dict]:
    """CE over valid (label >= 0) positions + z-loss ``z_coef * lse**2``,
    all f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, torch.clamp(labels, min=0)[..., None].long()
                      )[..., 0]
    valid = (labels >= 0).float()
    n = torch.clamp(valid.sum(), min=1.0)
    xent = torch.sum((lse - ll) * valid) / n
    zloss = z_coef * torch.sum((lse ** 2) * valid) / n
    return xent + zloss, {"xent": xent, "zloss": zloss, "ppl_tokens": n}

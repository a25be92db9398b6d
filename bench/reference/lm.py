"""Plain PyTorch reference of the decoder families the benchmark runs
(``moe`` and ``hybrid``, and ``dense``): the forward pass, the training
loss, its gradients (autograd), AdamW, and the serve state a prefill packs.

It is written from the models' published descriptions and from the port's
documented semantics, and imports nothing of the program (no ``repro``,
``repro_torch`` or ``jax``): it is what the benchmark's ``correct`` holds
the program to.  Everything is f32 with TF32 off (``precision("f32")``);
``precision("fp8")`` rounds both operands of every matrix product (and the
incoming gradient of each, in the backward) to float8 e4m3 with one scale
per tensor: the control, one precision below the configurations' bf16.

The parameters are a flat dict ``path -> tensor`` in the checkpoint layout
that both of the repo's packages read and write: layers stacked along a
leading axis, dense weights ``(d_in, d_out)`` (``x @ w``), expert weights
``(e, d, f)`` / ``(e, f, d)``, ``embed`` and ``unembed`` ``(vocab, d)``.

The model, as the configuration files state it:

* embedding lookup; pre-norm blocks; RMSNorm (eps 1e-6, f32); rotary
  embedding on q and k (half split, ``theta ** (-i / (dh / 2))``); GQA
  attention, scale ``1 / sqrt(dh)``, causal, and a sliding window of
  ``window`` keys (``k > q - window``) on every hybrid layer not in
  ``global_layers``; SiLU-gated MLP ``wd(silu(wg x) * wu x)``;
* moe: router ``softmax(x @ router)`` in f32, top-k renormalized, each
  expert taking at most ``capacity = max(round(t k / e * cf), min(t, 2k))``
  of the microbatch's ``t`` tokens' assignments, first come (token order,
  then rank) first served, the rest dropped; the Switch aux loss ``coef * e
  * sum(mean prob * share of assignments)`` added to the loss;
* hybrid (Hymba's parallel heads): attention and a Mamba2 mixer read the
  same normed input and are averaged, ``x + 0.5 (attn + ssm)``, then the
  MLP; the mixer: in_proj to z, x, B, C, dt; a causal depthwise conv of
  width 4 (with bias, SiLU) over x, B, C; ``dt = softplus(dt + dt_bias)``,
  per-step log decay ``a = -exp(a_log) dt``; the SSD recurrence ``S_t =
  exp(a_t) S_{t-1} + (dt x_t) B_t^T``, ``y_t = S_t C_t + d_skip dt x_t``
  from the zero state; ``rmsnorm(y * silu(z))``; out_proj;
* logits ``norm(x) @ unembed^T``; loss the mean token cross-entropy plus
  ``1e-4 * mean(lse^2)``.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

RMS_EPS = 1e-6
Z_COEF = 1e-4
SSD_CHUNK = 128
#: Query rows per block of the attention (bounds one block's logits).
Q_BLOCK = 512
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0

_MODE = {"prec": "f32"}


@contextlib.contextmanager
def precision(mode: str = "f32"):
    """Run the reference in ``"f32"`` (TF32 off everywhere) or ``"fp8"``
    (matrix products on e4m3-rounded operands, the rest f32)."""
    if mode not in ("f32", "fp8"):
        raise ValueError(f"unknown precision {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision(), _MODE["prec"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _MODE["prec"] = mode
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
        _MODE["prec"] = saved[3]


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per tensor (its largest
    magnitude at 448), back in f32."""
    scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(FP8).to(torch.float32) / scale


class _Fp8Product(torch.autograd.Function):
    """``einsum(eq, a, b)`` on e4m3-rounded operands; the backward rounds
    the incoming gradient too and differentiates the same product."""

    @staticmethod
    def forward(ctx, eq, a, b):
        a8, b8 = to_fp8(a), to_fp8(b)
        ctx.save_for_backward(a8, b8)
        ctx.eq = eq
        return torch.einsum(eq, a8, b8)

    @staticmethod
    def backward(ctx, grad):
        a8, b8 = ctx.saved_tensors
        with torch.enable_grad():
            a_ = a8.detach().requires_grad_()
            b_ = b8.detach().requires_grad_()
            out = torch.einsum(ctx.eq, a_, b_)
            da, db = torch.autograd.grad(out, (a_, b_), to_fp8(grad))
        return None, da, db


def product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Every matrix product of the reference goes through here."""
    if _MODE["prec"] == "fp8":
        return _Fp8Product.apply(eq, a, b)
    return torch.einsum(eq, a, b)


# ---------------------------------------------------------------------------
# The parameter tree and its seeded init
# ---------------------------------------------------------------------------


def d_inner(cfg: dict) -> int:
    return cfg["ssm_expand"] * cfg["d_model"]


def ssm_heads(cfg: dict) -> int:
    return d_inner(cfg) // cfg["ssm_head_dim"]


def conv_dim(cfg: dict) -> int:
    return d_inner(cfg) + 2 * cfg["ssm_groups"] * cfg["ssm_state"]


def param_specs(cfg: dict) -> list[tuple[tuple, tuple, tuple]]:
    """``(path, shape, init)`` of every leaf, paths sorted.  ``init`` is
    ``("normal", std)``, ``("const", value)`` or ``("a_log",)`` (log of
    ``linspace(1, 16, heads)``): the scales of the models' init (GPT-2
    style, output projections at ``0.02 / sqrt(2 L)``)."""
    L, d, V = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"]
    hq, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    out = ("normal", 0.02 / math.sqrt(2 * L))
    w = ("normal", 0.02)
    one, zero = ("const", 1.0), ("const", 0.0)
    specs = {
        ("embed",): ((V, d), w),
        ("unembed",): ((V, d), w),
        ("final_norm", "scale"): ((d,), one),
        ("layers", "norm1", "scale"): ((L, d), one),
        ("layers", "norm2", "scale"): ((L, d), one),
        ("layers", "attn", "wq", "w"): ((L, d, hq * dh), w),
        ("layers", "attn", "wk", "w"): ((L, d, hkv * dh), w),
        ("layers", "attn", "wv", "w"): ((L, d, hkv * dh), w),
        ("layers", "attn", "wo", "w"): ((L, hq * dh, d), out),
    }
    fam = cfg["family"]
    if fam == "moe":
        e, f = cfg["n_experts"], cfg["d_ff"]
        specs.update({
            ("layers", "moe", "router", "w"): ((L, d, e), w),
            ("layers", "moe", "wg"): ((L, e, d, f), w),
            ("layers", "moe", "wu"): ((L, e, d, f), w),
            ("layers", "moe", "wd"): ((L, e, f, d), out),
        })
    else:
        f = cfg["d_ff"]
        specs.update({
            ("layers", "mlp", "wg", "w"): ((L, d, f), w),
            ("layers", "mlp", "wu", "w"): ((L, d, f), w),
            ("layers", "mlp", "wd", "w"): ((L, f, d), out),
        })
    if fam == "hybrid":
        di, nh = d_inner(cfg), ssm_heads(cfg)
        g, ds, cw = cfg["ssm_groups"], cfg["ssm_state"], cfg["conv_width"]
        specs.update({
            ("layers", "ssm", "in_proj", "w"): ((L, d, 2 * di + 2 * g * ds
                                                 + nh), w),
            ("layers", "ssm", "out_proj", "w"): ((L, di, d), out),
            ("layers", "ssm", "conv_w"): ((L, cw, conv_dim(cfg)),
                                          ("normal", 0.2)),
            ("layers", "ssm", "conv_b"): ((L, conv_dim(cfg)), zero),
            ("layers", "ssm", "a_log"): ((L, nh), ("a_log",)),
            ("layers", "ssm", "dt_bias"): ((L, nh), zero),
            ("layers", "ssm", "d_skip"): ((L, nh), one),
            ("layers", "ssm", "norm"): ((L, di), one),
        })
    return [(p, *specs[p]) for p in sorted(specs)]


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` for run seed ``seed`` (any
    non-negative int, larger than 64 bits too)."""
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (2 ** 63 - 1)


def make_leaf(spec: tuple, seed: int, index: int, device) -> torch.Tensor:
    """One leaf from the seed, f32, drawn on ``device`` in one call."""
    _, shape, init = spec
    if init[0] == "const":
        return torch.full(shape, init[1], dtype=torch.float32, device=device)
    if init[0] == "a_log":
        row = torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                       dtype=torch.float32, device=device))
        return row.expand(shape).contiguous()
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return t.mul_(init[1])


def make_params(cfg: dict, seed: int, device) -> dict:
    """Every leaf of ``param_specs`` from ``seed``, f32 on ``device``."""
    return {spec[0]: make_leaf(spec, seed, i, device)
            for i, spec in enumerate(param_specs(cfg))}


def layer_view(params: dict, i: int) -> dict:
    """Layer ``i``'s leaves, keyed by their path below ``layers``."""
    return {".".join(p[1:]): t[i] for p, t in params.items()
            if p[0] == "layers"}


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + RMS_EPS) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (b, h, s, dh), positions 0..s-1."""
    s, dh = x.shape[-2], x.shape[-1]
    half = dh // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int | None) -> torch.Tensor:
    """Causal GQA softmax attention, q (b, hq, s, dh) against k, v (b, hkv,
    s, dh), keys ``j`` with ``q - window < j <= q`` (all ``j <= q`` for
    ``window`` None), in blocks of ``Q_BLOCK`` query rows."""
    b, hq, s, dh = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, s, dh) * (1.0 / math.sqrt(dh))
    outs = []
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(s, q0 + Q_BLOCK)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, q1, device=q.device)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        logits = product("bhgqd,bhkd->bhgqk", qg[:, :, :, q0:q1],
                         k[:, :, k0:q1])
        p = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(product("bhgqk,bhkd->bhgqd", p, v[:, :, k0:q1]))
    return torch.cat(outs, dim=3).reshape(b, hq, s, dh)


def self_attention(cfg: dict, p: dict, h: torch.Tensor, window):
    """wo(attention(rope(q), rope(k), v)) and the layer's (k, v)."""
    b, s, _ = h.shape
    hq, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]

    def heads(w, n):
        return product("bsd,de->bse", h, w).reshape(b, s, n, dh
                                                    ).transpose(1, 2)

    q = rope(heads(p["attn.wq.w"], hq), cfg["rope_theta"])
    k = rope(heads(p["attn.wk.w"], hkv), cfg["rope_theta"])
    v = heads(p["attn.wv.w"], hkv)
    o = attention(q, k, v, window).transpose(1, 2).reshape(b, s, hq * dh)
    return product("bse,ed->bsd", o, p["attn.wo.w"]), (k, v)


def gated_mlp(x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    h = F.silu(product("bsd,df->bsf", x, wg)) * product("bsd,df->bsf", x, wu)
    return product("bsf,fd->bsd", h, wd)


def capacity(cfg: dict, t: int) -> int:
    k, e = cfg["top_k"], cfg["n_experts"]
    cap = int(max(1, round(t * k / e * cfg["capacity_factor"])))
    return max(cap, min(t, 2 * k))


def moe(cfg: dict, p: dict, h: torch.Tensor):
    """Routed experts over the microbatch's tokens -> (out, aux loss)."""
    b, s, d = h.shape
    e, k = cfg["n_experts"], cfg["top_k"]
    x = h.reshape(b * s, d)
    t = x.shape[0]
    probs = torch.softmax(product("td,de->te", x, p["moe.router.w"]), -1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    eid = top_i.reshape(-1)                       # assignment t * k + j
    share = torch.bincount(eid, minlength=e).float() / eid.numel()
    aux = cfg["router_aux_coef"] * e * torch.sum(probs.mean(0) * share)
    onehot = F.one_hot(eid, e)
    rank = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
    keep = rank < capacity(cfg, t)
    wgt = top_p.reshape(-1)
    out = torch.zeros_like(x)
    for j in range(e):
        sel = torch.nonzero(keep & (eid == j)).reshape(-1)
        if sel.numel() == 0:
            continue
        tok = sel // k
        xe = x[tok][None]
        ye = gated_mlp(xe, p["moe.wg"][j], p["moe.wu"][j], p["moe.wd"][j])[0]
        out = out.index_add(0, tok, ye * wgt[sel][:, None])
    return out.reshape(b, s, d), aux


def ssd(x: torch.Tensor, a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor):
    """The SSD recurrence from the zero state, chunk by chunk (the chunk
    only orders the sums).  x (b, s, nh, dh), a (b, s, nh) log decays,
    bm / cm (b, s, g, ds) -> y (b, s, nh, dh), final state (b, nh, dh,
    ds)."""
    b, s, nh, dh = x.shape
    rep = nh // bm.shape[2]
    state = torch.zeros((b, nh, dh, bm.shape[3]), device=x.device)
    ys = []
    for c0 in range(0, s, SSD_CHUNK):
        c1 = min(s, c0 + SSD_CHUNK)
        n = c1 - c0
        xs = x[:, c0:c1]
        cum = torch.cumsum(a[:, c0:c1], dim=1).transpose(1, 2)   # (b, nh, n)
        bk = torch.repeat_interleave(bm[:, c0:c1], rep, dim=2)
        ck = torch.repeat_interleave(cm[:, c0:c1], rep, dim=2)
        tri = torch.tril(torch.ones(n, n, dtype=torch.bool, device=x.device))
        seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(
            ~tri, float("-inf"))
        gmat = product("bths,bjhs->bhtj", ck, bk) * torch.exp(seg)
        y = product("bhtj,bjhd->bthd", gmat, xs)
        y = y + product("bths,bhds->bthd",
                        ck * torch.exp(cum).transpose(1, 2)[..., None], state)
        ys.append(y)
        total = cum[..., -1]                                      # (b, nh)
        w = torch.exp(total[..., None] - cum).transpose(1, 2)     # (b, n, nh)
        state = torch.exp(total)[..., None, None] * state + product(
            "bjhd,bjhs->bhds", xs, bk * w[..., None])
    return torch.cat(ys, dim=1), state


def mamba(cfg: dict, p: dict, h: torch.Tensor):
    """The Mamba2 mixer -> (out, final SSD state, raw conv tail)."""
    b, s, _ = h.shape
    di, nh, dh = d_inner(cfg), ssm_heads(cfg), cfg["ssm_head_dim"]
    g, ds, cw = cfg["ssm_groups"], cfg["ssm_state"], cfg["conv_width"]
    zxbcdt = product("bsd,de->bse", h, p["ssm.in_proj.w"])
    z, xbc, dt = zxbcdt[..., :di], zxbcdt[..., di:-nh], zxbcdt[..., -nh:]
    pad = F.pad(xbc, (0, 0, cw - 1, 0))
    conv = sum(pad[:, i:i + s] * p["ssm.conv_w"][i] for i in range(cw))
    xc = F.silu(conv + p["ssm.conv_b"])
    xs = xc[..., :di].reshape(b, s, nh, dh)
    bm = xc[..., di:di + g * ds].reshape(b, s, g, ds)
    cm = xc[..., di + g * ds:].reshape(b, s, g, ds)
    dt = F.softplus(dt + p["ssm.dt_bias"])
    xin = xs * dt[..., None]
    y, s_fin = ssd(xin, -torch.exp(p["ssm.a_log"]) * dt, bm, cm)
    y = (y + xin * p["ssm.d_skip"][:, None]).reshape(b, s, di)
    y = rmsnorm(y * F.silu(z), p["ssm.norm"])
    return (product("bse,ed->bsd", y, p["ssm.out_proj.w"]), s_fin,
            xbc[:, s - (cw - 1):])


def layer_window(cfg: dict, i: int):
    """Layer ``i``'s attention window: None for a full causal layer."""
    if cfg["family"] == "hybrid" and i in cfg["global_layers"]:
        return None
    return cfg.get("window")


def block(cfg: dict, p: dict, x: torch.Tensor, i: int):
    """Layer ``i`` -> (x, aux loss, {"kv", "ssm", "conv"})."""
    kept: dict = {}
    aux = x.new_zeros(())
    h = rmsnorm(x, p["norm1.scale"])
    a_out, kept["kv"] = self_attention(cfg, p, h, layer_window(cfg, i))
    if cfg["family"] == "hybrid":
        y, kept["ssm"], kept["conv"] = mamba(cfg, p, h)
        x = x + 0.5 * (a_out + y)
    else:
        x = x + a_out
    h = rmsnorm(x, p["norm2.scale"])
    if cfg["family"] == "moe":
        m, aux = moe(cfg, p, h)
    else:
        m = gated_mlp(h, p["mlp.wg.w"], p["mlp.wu.w"], p["mlp.wd.w"])
    return x + m, aux, kept


def logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    return product("bsd,vd->bsv", rmsnorm(x, params[("final_norm", "scale")]),
                   params[("unembed",)])


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _layer(cfg: dict, i: int, names: list, x: torch.Tensor, *leaves):
    out, aux, _ = block(cfg, dict(zip(names, leaves)), x, i)
    return out, aux


def loss_fn(cfg: dict, params: dict, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """The training loss of one microbatch, each layer recomputed in the
    backward (``checkpoint``) so that the reference fits on the card."""
    x = params[("embed",)][tokens.long()]
    aux = x.new_zeros(())
    for i in range(cfg["n_layers"]):
        p = layer_view(params, i)
        x, a = checkpoint(_layer, cfg, i, list(p), x, *p.values(),
                          use_reentrant=False)
        aux = aux + a
    lf = logits(params, x)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (lse - ll).mean() + Z_COEF * (lse ** 2).mean() + aux


def adamw_lr(job: dict, step: int) -> float:
    """The learning rate of update ``step`` (1 for the first): linear
    warm-up ``lr (step + 1) / warmup``, then cosine to ``min_lr_frac``."""
    lr, warm = job["lr"], job["warmup"]
    if step < warm:
        return lr * (step + 1) / max(warm, 1)
    t = min(max((step - warm) / max(job["total_steps"] - warm, 1), 0.0), 1.0)
    frac = job["min_lr_frac"]
    return lr * (frac + (1 - frac) * 0.5 * (1 + math.cos(math.pi * t)))


def train(cfg: dict, job: dict, params: dict, batches) -> dict:
    """Steps of ``job`` (``grad_accum`` microbatches, the gradient clipped
    to ``clip`` by its global norm, AdamW) from ``params``, which are
    updated in place, on ``batches`` of ``(tokens, labels)`` -> ``{"losses":
    each step's mean microbatch loss, "grad_norms": each leaf's norm of the
    first step's clipped gradient, as the optimizer got it}``."""
    b1, b2, eps, wd = job["b1"], job["b2"], job["eps"], job["weight_decay"]
    n = job["grad_accum"]
    m = {k: torch.zeros_like(t) for k, t in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    out = {"losses": [], "grad_norms": {}}
    for step, (tokens, labels) in enumerate(batches, start=1):
        for t in params.values():
            t.requires_grad_(True)
        total = 0.0
        for mt, ml in zip(torch.chunk(tokens, n), torch.chunk(labels, n)):
            loss = loss_fn(cfg, params, mt, ml)
            loss.backward()
            total += float(loss.detach())
        out["losses"].append(total / n)
        with torch.no_grad():
            grads = {}
            for k, t in params.items():
                grads[k] = t.grad.div_(n)
                t.grad = None
                t.requires_grad_(False)
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            scale = torch.clamp(job["clip"] / norm.clamp(min=1e-9), max=1.0)
            lr = adamw_lr(job, step)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for k, p in params.items():
                g = grads.pop(k).mul_(scale)
                if step == 1:
                    out["grad_norms"][k] = float(g.norm())
                m[k].mul_(b1).add_((1 - b1) * g)
                v[k].mul_(b2).add_((1 - b2) * g * g)
                upd = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
                p.sub_(lr * (upd + (wd if p.ndim >= 2 else 0.0) * p))
    return out


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill(cfg: dict, params: dict, tokens: torch.Tensor, cap: int) -> dict:
    """The serve state after ``tokens (b, s)`` in the engine's documented
    layout, f32, and the last token's logits (b, vocab):

    * moe / dense: ``kv_k`` / ``kv_v`` (L, b, hkv, cap, dh), positions
      ``< s`` filled (k after rope);
    * hybrid: ``ring_k`` / ``ring_v`` (L, b, hkv, W, dh), W = min(window,
      cap), position p at slot ``p % W`` for the last ``min(s, W)``
      positions; ``glob_k`` / ``glob_v`` (global layers, b, hkv, cap, dh);
      ``ssm`` (L, b, nh, dh, ds) the final SSD states; ``conv`` (L, b,
      width - 1, conv_dim) the mixer's last raw (pre-conv) inputs;
    * ``pos`` = s.
    """
    b, s = tokens.shape
    L, hkv, dh = cfg["n_layers"], cfg["n_kv_heads"], cfg["d_head"]
    dev = tokens.device
    state: dict = {"pos": s}
    hybrid = cfg["family"] == "hybrid"
    if hybrid:
        w = min(cfg["window"], cap)
        n_fill = min(s, w)
        slots = torch.arange(s - n_fill, s, device=dev) % w
        gl = list(cfg["global_layers"])
        for n in ("ring_k", "ring_v"):
            state[n] = torch.zeros((L, b, hkv, w, dh), device=dev)
        for n in ("glob_k", "glob_v"):
            state[n] = torch.zeros((len(gl), b, hkv, cap, dh), device=dev)
        state["ssm"] = torch.zeros((L, b, ssm_heads(cfg), cfg["ssm_head_dim"],
                                    cfg["ssm_state"]), device=dev)
        state["conv"] = torch.zeros((L, b, cfg["conv_width"] - 1,
                                     conv_dim(cfg)), device=dev)
    else:
        for n in ("kv_k", "kv_v"):
            state[n] = torch.zeros((L, b, hkv, cap, dh), device=dev)
    x = params[("embed",)][tokens.long()]
    for i in range(L):
        x, _, kept = block(cfg, layer_view(params, i), x, i)
        k, v = kept["kv"]
        if hybrid:
            state["ring_k"][i][:, :, slots] = k[:, :, s - n_fill:]
            state["ring_v"][i][:, :, slots] = v[:, :, s - n_fill:]
            if i in gl:
                state["glob_k"][gl.index(i), :, :, :s] = k
                state["glob_v"][gl.index(i), :, :, :s] = v
            state["ssm"][i] = kept["ssm"]
            state["conv"][i] = kept["conv"]
        else:
            state["kv_k"][i, :, :, :s] = k
            state["kv_v"][i, :, :, :s] = v
    return state, logits(params, x[:, -1:])[:, -1]

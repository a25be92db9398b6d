"""Plain PyTorch versions of the hand kernels (the ``ref.py`` contract).

Counterparts of ``repro.kernels.ref``: simple, obviously-correct functions
that the CPU tests hold the port to, and that ``chip_smoke.py`` holds the
hand kernels to on the card.  They are what a wrapper runs for a tensor on
the CPU; nothing on the main path runs them for a CUDA tensor.

Batch dimensions are written out instead of ``vmap``: leading dimensions
broadcast, and the solver is vectorised over lanes and loops only over
coordinates.
"""
from __future__ import annotations

import torch


#: Coordinate-block size of the blocked solver; the hand kernel's block
#: (``kBlock`` in ``csrc/solver.cu``) is the same constant.
SOLVER_BLOCK = 16


def _g(gamma, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(gamma, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# RBF / sech2 kernel matrices (the paper's hot loop)
# ---------------------------------------------------------------------------


def rbf_matrix(x: torch.Tensor, z: torch.Tensor, gamma) -> torch.Tensor:
    """K[..., i, j] = exp(-gamma * ||x_i - z_j||^2).

    ``x (..., n, d)``, ``z (..., m, d)``, ``gamma`` a scalar or a tensor of
    the batch shape.
    """
    d2 = (torch.sum(x * x, -1)[..., :, None]
          + torch.sum(z * z, -1)[..., None, :]
          - 2.0 * (x @ z.transpose(-1, -2)))
    g = _g(gamma, x)[..., None, None]
    return torch.exp(-g * torch.clamp(d2, min=0.0))


def sech2_matrix(x: torch.Tensor, z: torch.Tensor, gamma,
                 n_slope: float = 1.38, v_t: float = 0.02585,
                 v_scale: float = 0.5) -> torch.Tensor:
    """Hardware separable kernel (Eq. 6): product of per-dim sech2 cells."""
    gamma0 = 1.0 / (4.0 * n_slope**2 * v_t**2) * v_scale**2
    s = torch.sqrt(_g(gamma, x) / gamma0)[..., None, None, None]
    dv = v_scale * s * (x[..., :, None, :] - z[..., None, :, :]) \
        / (n_slope * v_t)
    cell = 4.0 / ((1.0 + torch.exp(-dv)) * (1.0 + torch.exp(dv)))
    return torch.prod(cell, dim=-1)


# ---------------------------------------------------------------------------
# Dual coordinate ascent over solver lanes (the training hot loop)
# ---------------------------------------------------------------------------


def dual_ascent_blocked(kp: torch.Tensor, y: torch.Tensor,
                        c_box: torch.Tensor, n_epochs: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked Gauss-Seidel dual ascent on materialized Grams ``K' = K + 1``.

    ``kp (..., n, n)``, ``y (..., n)`` and the lanes' boxes
    ``c_box (..., L, n)``; the leading dimensions broadcast.  The update
    sequence is that of ``repro.core.trainer.dual_coordinate_ascent_blocked``:
    per block of ``SOLVER_BLOCK`` coordinates, fresh margins from all columns
    (``rows @ (alpha * y)``), then Gauss-Seidel inside the block.  Returns
    ``(alpha, f)``, each ``(..., L, n)``, with the final margins
    ``f = K' @ (alpha * y)``.
    """
    n = kp.shape[-1]
    block = min(SOLVER_BLOCK, n)
    n_pad = -(-n // block) * block
    if n_pad != n:
        pad = n_pad - n
        kp = torch.nn.functional.pad(kp, (0, pad, 0, pad))
        y = torch.nn.functional.pad(y, (0, pad), value=1.0)
        c_box = torch.nn.functional.pad(c_box, (0, pad))
    y = y[..., None, :]                                    # (..., 1, n)
    kpt = kp.transpose(-1, -2)
    qdiag = torch.clamp(torch.diagonal(kp, dim1=-2, dim2=-1), min=1e-12)
    lanes = torch.broadcast_shapes(kp.shape[:-2] + (1,), y.shape[:-1],
                                   c_box.shape[:-1])
    alpha = torch.zeros(lanes + (n_pad,), dtype=kp.dtype, device=kp.device)

    def flat(t):  # (..., blk) -> (blk, lanes): a contiguous copy
        return t.expand(lanes + t.shape[-1:]).reshape(-1, t.shape[-1]).T \
            .clone(memory_format=torch.contiguous_format)

    for _ in range(int(n_epochs)):
        for j0 in range(0, n_pad, block):
            sl = slice(j0, j0 + block)
            fb = flat((alpha * y) @ kpt[..., :, sl])       # fresh margins
            kbb = kp[..., None, sl, sl]                    # [.., r, i]
            kcol = kbb.expand(lanes + kbb.shape[-2:]).reshape(
                -1, block, block).permute(2, 1, 0).contiguous()  # [i, r, l]
            ab, yb = flat(alpha[..., sl]), flat(y[..., sl])
            cb, qb = flat(c_box[..., sl]), flat(qdiag[..., None, sl])
            for i in range(block):
                g = 1.0 - yb[i] * fb[i]
                a_new = torch.minimum(
                    torch.clamp(ab[i] + g / qb[i], min=0.0), cb[i])
                fb += ((a_new - ab[i]) * yb[i]) * kcol[i]
                ab[i] = a_new
            alpha[..., sl] = ab.T.reshape(lanes + (block,))
    f = (alpha * y) @ kpt
    return alpha[..., :n], f[..., :n]


def lane_grams(x: torch.Tensor, gamma: torch.Tensor, kind: str,
               n_slope: float = 1.38, v_t: float = 0.02585,
               v_scale: float = 1.0) -> torch.Tensor:
    """Per-(pair, gamma) Gram with the bias folded in: ``(P, G, n, n)``."""
    xg = x[:, None]                                        # (P, 1, n, d)
    if kind == "linear":
        k = (x @ x.transpose(-1, -2))[:, None].expand(
            -1, gamma.shape[1], -1, -1)
    elif kind == "rbf":
        k = rbf_matrix(xg, xg, gamma)
    elif kind == "sech2":
        k = sech2_matrix(xg, xg, gamma, n_slope, v_t, v_scale)
    else:
        raise ValueError(f"no lanes oracle for kernel kind {kind!r}")
    return k + 1.0


def solve_lanes(x: torch.Tensor, y: torch.Tensor, c_box: torch.Tensor,
                gamma: torch.Tensor, kind: str = "rbf", n_epochs: int = 200,
                n_slope: float = 1.38, v_t: float = 0.02585,
                v_scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Lanes oracle: materialized per-(pair, gamma) Gram + the blocked
    update sequence over ``(P, G, L)``.  ``x (P, n, d)``, ``y (P, n)``,
    ``c_box (P, L, n)``, ``gamma (P, G)``; returns ``(alpha, f)``, each
    ``(P, G, L, n)``."""
    kp = lane_grams(x, gamma, kind, n_slope, v_t, v_scale)
    return solve_lanes_gram(kp, y, c_box, n_epochs)


def solve_lanes_gram(kp: torch.Tensor, y: torch.Tensor, c_box: torch.Tensor,
                     n_epochs: int = 200) -> tuple[torch.Tensor, torch.Tensor]:
    """The same lanes on stored Grams ``kp (P, G, n, n)`` (bias folded in):
    the plain version of the solver's Gram-input mode."""
    return dual_ascent_blocked(kp, y[:, None], c_box[:, None], n_epochs)


# ---------------------------------------------------------------------------
# Attention (the LM substrate)
# ---------------------------------------------------------------------------

#: The masked logit of the online softmax, as in the reference.
NEG_INF = -1e30

#: kv block of the online softmax; the hand kernel's ``kBlockK`` in
#: ``csrc/flash_attention.cu`` is the same constant.
FLASH_BLOCK_K = 64


def _attn_mask(sq: int, k0: int, n: int, causal: bool, window, q_offset,
               device) -> torch.Tensor:
    """(sq, n) bool: may query row i see key ``k0 + j``?"""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(k0, k0 + n, device=device)[None, :]
    mask = torch.ones((sq, n), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int | None = None,
              q_offset: int = 0) -> torch.Tensor:
    """Plain GQA attention with optional causal / sliding-window masking
    (the oracle, ``repro.kernels.ref.attention``).

    ``q (b, hq, sq, dh)``, ``k, v (b, hkv, skv, dh)``; ``q_offset``
    positions the query block within the kv sequence.  Materializes the
    whole (sq, skv) logit matrix: for small shapes only.
    """
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, sq, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) / float(dh) ** 0.5
    mask = _attn_mask(sq, 0, skv, causal, window, q_offset, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v)
    return out.reshape(b, hq, sq, dh)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Plain version of K3: online softmax over kv blocks of
    ``FLASH_BLOCK_K``, step by step as ``_flash_kernel`` computes it.

    q is cast to f32 and scaled by ``1/sqrt(dh)``; the running max,
    denominator and accumulator are f32; masked lanes are zeroed by
    ``p = exp(l - m) * mask``; kv blocks dead for every query row are
    skipped; the output is ``acc / max(l, 1e-30)`` in q's dtype.  Peak
    memory is one (sq, FLASH_BLOCK_K) logit block per head.
    """
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, sq, dh).float() * (1.0 / float(dh) ** 0.5)
    m = torch.full((b, hkv, group, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, group, sq, dh), device=q.device)
    q_lo, q_hi = q_offset, q_offset + sq - 1
    for k0 in range(0, skv, FLASH_BLOCK_K):
        if causal and k0 > q_hi:
            break
        if window is not None and k0 + FLASH_BLOCK_K - 1 <= q_lo - window:
            continue
        kb = k[:, :, k0:k0 + FLASH_BLOCK_K].float()
        vb = v[:, :, k0:k0 + FLASH_BLOCK_K].float()
        mask = _attn_mask(sq, k0, kb.shape[2], causal, window, q_offset,
                          q.device)
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb)
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new) * mask
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, sq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality)
# ---------------------------------------------------------------------------


def ssd(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
        cmat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential scan oracle of SSD: ``S_t = exp(a_t) S_{t-1} + x_t B_t^T``,
    ``y_t = S_t C_t`` from the zero state (``repro.kernels.ref.ssd``).

    ``x (b, s, h, dh)``, ``a (b, s, h)``, ``bmat, cmat (b, s, g, ds)`` with
    heads grouped over the g state groups (head h reads group h // (h/g)).
    Returns ``(y (b, s, h, dh), final_state (b, h, dh, ds))``.
    """
    b, s, h, dh = x.shape
    rep = h // bmat.shape[2]
    bm = torch.repeat_interleave(bmat, rep, dim=2)
    cm = torch.repeat_interleave(cmat, rep, dim=2)
    state = torch.zeros((b, h, dh, bm.shape[-1]), dtype=x.dtype,
                        device=x.device)
    ys = []
    for t in range(s):
        state = torch.exp(a[:, t])[..., None, None] * state \
            + x[:, t, :, :, None] * bm[:, t, :, None, :]
        ys.append(torch.einsum("bhds,bhs->bhd", state, cm[:, t]))
    return torch.stack(ys, dim=1), state


def ssd_scan(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, chunk: int = 128
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: the chunked SSD scan, chunk by chunk as
    ``_ssd_kernel`` computes it, in the model's layout.

    ``x (b, s, nh, dh)``, ``a (b, s, nh)``, ``bmat, cmat (b, s, g, ds)``,
    all f32, ``s % chunk == 0`` (pad upstream with zeros), from the zero
    state.  Per chunk, with
    ``cum = cumsum(a)``: ``y = ((C B^T) * decay) x + (C * exp(cum)) S^T``
    with ``decay[t, j] = exp(min(cum_t - cum_j, 0))`` selected for j <= t,
    then ``S <- exp(cum_L) S + x^T (B * exp(cum_L - cum))``.  Returns
    ``(y (b, s, nh, dh), final_state (b, nh, dh, ds))``, both f32.
    """
    b, s, nh, dh = x.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    rep = nh // g
    if s % chunk:
        raise ValueError(f"s = {s} is not a multiple of chunk = {chunk}")
    state = torch.zeros((b, nh, dh, ds), device=x.device)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        xk = x[:, sl].float()                                 # (b, L, nh, dh)
        cum = torch.cumsum(a[:, sl].float(), dim=1)           # (b, L, nh)
        bk = torch.repeat_interleave(bmat[:, sl].float(), rep, dim=2)
        ck = torch.repeat_interleave(cmat[:, sl].float(), rep, dim=2)
        total = cum[:, -1]                                    # (b, nh)
        gmat = torch.einsum("blhs,bjhs->bhlj", ck, bk)        # C B^T
        cumt = cum.transpose(1, 2)                            # (b, nh, L)
        logdec = cumt[..., :, None] - cumt[..., None, :]      # cum_t - cum_j
        dec = torch.where(causal, torch.exp(torch.clamp(logdec, max=0.0)),
                          0.0)
        y_intra = torch.einsum("bhlj,bjhd->blhd", gmat * dec, xk)
        y_inter = torch.einsum("blhs,bhds->blhd",
                               ck * torch.exp(cum)[..., None], state)
        ys.append(y_intra + y_inter)
        w = torch.exp(total[:, None, :] - cum)                # (b, L, nh)
        state = torch.exp(total)[..., None, None] * state + torch.einsum(
            "blhd,blhs->bhds", xk, bk * w[..., None])
    return torch.cat(ys, dim=1), state

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


def _live_kv_blocks(sq: int, skv: int, causal: bool, window, q_offset,
                    block: int = FLASH_BLOCK_K):
    """Start of every kv block of ``block`` keys that some query row of
    ``[q_offset, q_offset + sq)`` can see (the kernels' skip rule)."""
    q_lo, q_hi = q_offset, q_offset + sq - 1
    for k0 in range(0, skv, block):
        if causal and k0 > q_hi:
            break
        if window is not None and k0 + block - 1 <= q_lo - window:
            continue
        yield k0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, return_lse: bool = False,
                    block_k: int = FLASH_BLOCK_K):
    """Plain version of K3: online softmax over kv blocks of
    ``FLASH_BLOCK_K``, step by step as ``_flash_kernel`` computes it.

    q is cast to f32 and scaled by ``1/sqrt(dh)``; the running max,
    denominator and accumulator are f32; masked lanes are zeroed by
    ``p = exp(l - m) * mask``; kv blocks dead for every query row are
    skipped; the output is ``acc / max(l, 1e-30)`` in q's dtype.  Peak
    memory is one (sq, FLASH_BLOCK_K) logit block per head.

    With ``return_lse`` it also returns the row log-sum-exp of the scaled
    logits, ``lse = m + log(l)`` (b, hq, sq) in f32, which the backward
    (``flash_attention_bwd``) reads; a row that sees no key has
    ``lse = -inf``.  ``block_k`` is the kv block (the kernel's unless a
    caller asks otherwise: the meta device's trace takes coarser blocks).
    """
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, sq, dh).float() * (1.0 / float(dh) ** 0.5)
    m = torch.full((b, hkv, group, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, group, sq, dh), device=q.device)
    for k0 in _live_kv_blocks(sq, skv, causal, window, q_offset, block_k):
        kb = k[:, :, k0:k0 + block_k].float()
        vb = v[:, :, k0:k0 + block_k].float()
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
    out = out.reshape(b, hq, sq, dh).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l)).reshape(b, hq, sq)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: int | None = None,
                        q_offset: int = 0, block_k: int = FLASH_BLOCK_K
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of K3's backward kernel (``csrc/flash_attention_bwd.cu``),
    written out kv block by kv block as the kernel computes it, not through
    autograd.

    In f32, with ``scale = 1/sqrt(dh)``: ``D = rowsum(dO * O)``; per live kv
    block of ``FLASH_BLOCK_K`` keys, ``P = exp(scale q k^T - lse)`` on the
    visible (query, key) pairs and 0 elsewhere, ``dP = dO v^T``, ``dS = P *
    (dP - D)``; ``dV = sum P^T dO`` and ``dK = scale sum dS^T q`` over the
    q heads of the kv head's group, ``dQ = scale sum dS k`` over the kv
    blocks.  ``lse`` is the forward's (b, hq, sq) f32 row log-sum-exp.
    Returns ``(dq, dk, dv)`` in the inputs' dtype; a row that sees no key
    gets a zero gradient.  ``block_k`` as in ``flash_attention``.
    """
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / float(dh) ** 0.5

    def grouped(t):
        return t.reshape(b, hkv, group, sq, -1).float()

    qg, dog = grouped(q), grouped(do)
    dd = (dog * grouped(o)).sum(-1, keepdim=True)          # D, (.., sq, 1)
    lse_g = lse.reshape(b, hkv, group, sq, 1).float()
    dq = torch.zeros_like(qg)
    dk = torch.zeros((b, hkv, skv, dh), device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in _live_kv_blocks(sq, skv, causal, window, q_offset, block_k):
        kb = k[:, :, k0:k0 + block_k].float()
        vb = v[:, :, k0:k0 + block_k].float()
        mask = _attn_mask(sq, k0, kb.shape[2], causal, window, q_offset,
                          q.device)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb) * scale
        p = torch.where(mask, torch.exp(s - lse_g), 0.0)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vb)
        ds = p * (dp - dd)
        sl = slice(k0, k0 + kb.shape[2])
        dv[:, :, sl] = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
        dk[:, :, sl] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
        dq += torch.einsum("bhgqk,bhkd->bhgqd", ds, kb)
    dq = (dq * scale).reshape(b, hq, sq, dh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def ssd_passes(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor, chunk: int = 128
               ) -> tuple[torch.Tensor, ...]:
    """Plain twin of ``ssd.ssd_passes_cuda``: K4's three pass twins in the
    card's order (chunk states, state pass, chunk scan) -> ``(y,
    final_state, cum (b, nh, s), s_prev (b, nh, nc, dh, ds))``, ``ssd_scan``'s
    outputs and what K4-bwd reads.  Every chunk at once but for the state
    recurrence, so a trace of it (the meta device's) is short."""
    if x.shape[1] % chunk:
        raise ValueError(f"s = {x.shape[1]} is not a multiple of chunk = "
                         f"{chunk}")
    cum, own = ssd_chunk_states(x, a, bmat, chunk)
    s_prev, s_fin = ssd_state_pass(cum, own, chunk)
    return ssd_chunk_scan(x, bmat, cmat, cum, s_prev, chunk), s_fin, cum, \
        s_prev


def ssd_chunk_states(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                     chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K4's first pass (``ssd_chunk_state_kernel``): each
    chunk's inclusive ``cum = cumsum(a)`` and its own contribution to the
    state, ``dS = x^T (B * exp(cum_L - cum))``.

    Inputs as ``ssd_scan``'s.  Returns ``(cum (b, nh, s), states (b, nh,
    s // chunk, dh, ds))``, both f32.
    """
    b, s, nh, dh = x.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    nc = s // chunk
    cum = torch.cumsum(a.float().reshape(b, nc, chunk, nh), dim=2)
    w = torch.exp(cum[:, :, -1:] - cum)                   # (b, nc, L, nh)
    bk = torch.repeat_interleave(bmat.float(), nh // g, dim=2).reshape(
        b, nc, chunk, nh, ds)
    states = torch.einsum("bclhd,bclhs->bhcds",
                          x.float().reshape(b, nc, chunk, nh, dh),
                          bk * w[..., None])
    return cum.permute(0, 3, 1, 2).reshape(b, nh, s), states


def ssd_state_pass(cum: torch.Tensor, states: torch.Tensor, chunk: int = 128
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K4's second pass (``ssd_state_pass_kernel``): from
    ``S = 0``, ``S <- exp(cum_L) S + dS`` chunk by chunk.

    ``cum (b, nh, s)`` and ``states (b, nh, nc, dh, ds)`` as
    ``ssd_chunk_states`` returns them.  Returns ``(s_prev (b, nh, nc, dh,
    ds), final_state (b, nh, dh, ds))``: the state entering each chunk, and
    the state after the last.
    """
    b, nh, s = cum.shape
    total = cum.reshape(b, nh, s // chunk, chunk)[..., -1]
    state = torch.zeros_like(states[:, :, 0])
    prev = []
    for c in range(states.shape[2]):
        prev.append(state)
        state = torch.exp(total[:, :, c])[..., None, None] * state \
            + states[:, :, c]
    return torch.stack(prev, dim=2), state


def ssd_chunk_scan(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                   cum: torch.Tensor, s_prev: torch.Tensor, chunk: int = 128
                   ) -> torch.Tensor:
    """Plain twin of K4's third pass (``ssd_chunk_scan_kernel``): every
    chunk at once, ``y = ((C B^T) * decay) x + (C * exp(cum)) S_prev^T``
    with ``decay`` selected to 0 above the diagonal, from the chunk's
    ``cum`` and entering state ``s_prev`` -> ``y (b, s, nh, dh)``."""
    b, s, nh, dh = x.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    nc = s // chunk

    def per_head(m):
        return torch.repeat_interleave(m.float(), nh // g, dim=2).reshape(
            b, nc, chunk, nh, ds)

    bk, ck = per_head(bmat), per_head(cmat)
    cumk = cum.reshape(b, nh, nc, chunk)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    logdec = cumk[..., :, None] - cumk[..., None, :]      # cum_t - cum_j
    dec = torch.where(causal, torch.exp(torch.clamp(logdec, max=0.0)), 0.0)
    gmat = torch.einsum("bcths,bcjhs->bhctj", ck, bk)     # C B^T
    y_intra = torch.einsum("bhctj,bcjhd->bcthd", gmat * dec,
                           x.float().reshape(b, nc, chunk, nh, dh))
    ecum = torch.exp(cumk).permute(0, 2, 3, 1)            # (b, nc, L, nh)
    y_inter = torch.einsum("bcths,bhcds->bcthd", ck * ecum[..., None], s_prev)
    return (y_intra + y_inter).reshape(b, s, nh, dh)


# ---------------------------------------------------------------------------
# The SSD scan's gradient (K4-bwd)
# ---------------------------------------------------------------------------


def _reverse_cumsum(dcum: torch.Tensor) -> torch.Tensor:
    """``da_i = sum_{t >= i} dcum_t`` along the last axis, summed in f64
    and rounded once (``a``'s gradient from ``cum``'s, within a chunk)."""
    rev = torch.flip(dcum.double(), [-1])
    return torch.flip(torch.cumsum(rev, -1), [-1]).to(dcum.dtype)


def ssd_scan_bwd(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, cum: torch.Tensor, s_prev: torch.Tensor,
                 s_fin: torch.Tensor, dy: torch.Tensor,
                 dfinal: torch.Tensor | None, chunk: int = 128
                 ) -> tuple[torch.Tensor, ...]:
    """Plain twin of K4-bwd: the gradient of ``ssd_scan`` in closed form,
    chunk by chunk from the last.

    Inputs as ``ssd_scan``'s, with the forward's ``cum (b, nh, s)`` and
    entering states ``s_prev (b, nh, nc, dh, ds)`` (``ssd_chunk_states``,
    ``ssd_state_pass``), its final state ``s_fin``, the output's gradient
    ``dy (b, s, nh, dh)`` and the final state's ``dfinal`` (``None``: 0).
    Per chunk and head, with ``G = C B^T``, ``P_tj = dy_t . x_j``,
    ``D_tj = exp(min(cum_t - cum_j, 0))`` for j <= t (else 0), ``M = G D
    P`` where ``cum_t - cum_j <= 0`` (the clamp passes no gradient above
    0), ``T = cum_L``, ``S`` / ``S'`` the states entering / leaving the
    chunk and ``dS'`` the gradient into ``S'``:

    * ``dx_j = sum_t G_tj D_tj dy_t + e^{T - cum_j} dS' B_j``
    * ``dB_j = sum_t D_tj P_tj C_t + e^{T - cum_j} dS'^T x_j``
    * ``dC_t = sum_j D_tj P_tj B_j + e^{cum_t} S^T dy_t``
    * ``dcum = rowsum(M) - colsum(M) + dy . y_inter - x . dx_inter``, plus
      ``<dS', S'>`` at the chunk's last step; ``da`` is its reverse
      cumsum within the chunk (in f64);
    * ``dS = sum_t e^{cum_t} dy_t C_t^T + e^T dS'``, the next ``dS'``.

    dB and dC are summed over each group's heads.  Returns ``(dx (b, s,
    nh, dh), da (b, s, nh), dbmat, dcmat (b, s, g, ds))``, all f32.
    """
    b, s, nh, dh = x.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    rep, nc = nh // g, s // chunk
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    dx, da = torch.empty_like(x), torch.empty_like(a)
    dbh = torch.empty((b, s, nh, ds), device=x.device)
    dch = torch.empty_like(dbh)
    dsn = torch.zeros_like(s_fin) if dfinal is None else dfinal.float()
    for c in reversed(range(nc)):
        sl = slice(c * chunk, (c + 1) * chunk)
        xk, dyk = x[:, sl].float(), dy[:, sl].float()      # (b, L, nh, dh)
        bk = torch.repeat_interleave(bmat[:, sl].float(), rep, dim=2)
        ck = torch.repeat_interleave(cmat[:, sl].float(), rep, dim=2)
        cumk = cum[:, :, sl]                                  # (b, nh, L)
        total = cumk[..., -1]                                 # (b, nh)
        s_in = s_prev[:, :, c]
        s_out = s_prev[:, :, c + 1] if c + 1 < nc else s_fin
        logdec = cumk[..., :, None] - cumk[..., None, :]      # cum_t - cum_j
        dec = torch.where(causal, torch.exp(torch.clamp(logdec, max=0.0)),
                          0.0)
        gmat = torch.einsum("bths,bjhs->bhtj", ck, bk)
        pmat = torch.einsum("bthd,bjhd->bhtj", dyk, xk)
        q, r = gmat * dec, pmat * dec
        m = torch.where(logdec <= 0, gmat * r, 0.0)
        w = torch.exp(total[..., None] - cumk)                # e^{T - cum_j}
        ec = torch.exp(cumk)                                  # e^{cum_t}
        dx_inter = torch.einsum("bhj,bhds,bjhs->bjhd", w, dsn, bk)
        db_inter = torch.einsum("bhj,bhds,bjhd->bjhs", w, dsn, xk)
        dc_inter = torch.einsum("bht,bhds,bthd->bths", ec, s_in, dyk)
        dx[:, sl] = torch.einsum("bhtj,bthd->bjhd", q, dyk) + dx_inter
        dbh[:, sl] = torch.einsum("bhtj,bths->bjhs", r, ck) + db_inter
        dch[:, sl] = torch.einsum("bhtj,bjhs->bths", r, bk) + dc_inter
        dcum = (m.sum(-1) - m.sum(-2)
                + torch.einsum("bths,bths->bht", ck, dc_inter)
                - torch.einsum("bjhs,bjhs->bhj", bk, db_inter))
        dcum[..., -1] += (dsn * s_out).sum((-2, -1))
        da[:, sl] = _reverse_cumsum(dcum).transpose(1, 2)
        dsn = torch.einsum("bht,bthd,bths->bhds", ec, dyk, ck) \
            + torch.exp(total)[..., None, None] * dsn
    return (dx, da, dbh.reshape(b, s, g, rep, ds).sum(3),
            dch.reshape(b, s, g, rep, ds).sum(3))


#: Heads of one group that a CTA of K4-bwd's per-slice passes owns at most;
#: the hand kernel's ``kMaxSlice`` (``csrc/ssd_bwd.cu``) is the same
#: constant.
SSD_BWD_SLICE = 8


def ssd_bwd_slices(rep: int) -> tuple[int, int]:
    """K4-bwd's head slices of a group of ``rep`` heads -> ``(heads per
    slice, slices)``: the fewest slices of at most ``SSD_BWD_SLICE`` heads,
    every one full but the last."""
    n = -(-rep // SSD_BWD_SLICE)
    per = -(-rep // n)
    return per, -(-rep // per)


def _by_slice(t: torch.Tensor, g: int, dim: int) -> torch.Tensor:
    """``t`` summed over each slice's heads along ``dim`` (nh long) -> that
    axis replaced by ``(g, slices)``; the ragged last slice has fewer."""
    rep = t.shape[dim] // g
    per, n = ssd_bwd_slices(rep)
    t = t.unflatten(dim, (g, rep))
    pad = n * per - rep
    if pad:
        zeros = list(t.shape)
        zeros[dim + 1] = pad
        t = torch.cat([t, t.new_zeros(zeros)], dim=dim + 1)
    return t.unflatten(dim + 1, (n, per)).sum(dim + 2)


def _chunks(m: torch.Tensor, chunk: int) -> torch.Tensor:
    """``(b, s, k, w)`` -> ``(b, nc, L, k, w)``."""
    return m.unflatten(1, (m.shape[1] // chunk, chunk))


def ssd_bwd_chunk_states(dy: torch.Tensor, cmat: torch.Tensor,
                         cum: torch.Tensor, s_prev: torch.Tensor,
                         chunk: int = 128) -> tuple[torch.Tensor, ...]:
    """Plain twin of K4-bwd's first pass (``ssd_bwd_chunk_state_kernel``):
    each chunk's own part of the gradient into the state entering it, ``U
    = sum_t (e^{cum_t} dy_t) C_t^T``, the entering state's part of dC,
    ``e^{cum_t} S^T dy_t``, summed over each slice of a group's heads
    (``ssd_bwd_slices``), and its term ``C_t . dC_t`` of dcum per head.

    Returns ``(u (b, nh, nc, dh, ds), dcp (b, s, g, slices, ds), dcum (b,
    nh, s))``.  Every product is a tensor-core product of the kernel (a
    two-operand ``einsum``); the dots run on its CUDA cores."""
    b, s, nh, dh = dy.shape
    g = cmat.shape[2]
    dyk, ck = _chunks(dy, chunk), _chunks(cmat, chunk)
    ckh = torch.repeat_interleave(ck, nh // g, dim=3)     # (b, nc, L, nh, ds)
    ec = torch.exp(cum.unflatten(2, (s // chunk, chunk))).permute(0, 2, 3, 1)
    u = torch.einsum("bclhd,bclhs->bhcds", dyk * ec[..., None], ckh)
    dci = torch.einsum("bclhd,bhcds->bclhs", dyk, s_prev) * ec[..., None]
    dcum = (ckh * dci).sum(-1).permute(0, 3, 1, 2).reshape(b, nh, s)
    return u, _by_slice(dci, g, 3).flatten(1, 2), dcum


def ssd_bwd_state_pass(cum: torch.Tensor, u: torch.Tensor,
                       dfinal: torch.Tensor | None, chunk: int = 128
                       ) -> torch.Tensor:
    """Plain twin of K4-bwd's second pass (``ssd_bwd_state_pass_kernel``):
    from the last chunk, ``dS' = dfinal`` (0 for ``None``), then ``dS' <-
    U_c + exp(cum_L of c) dS'`` for the chunk before.  Returns the gradient
    into the state leaving each chunk, ``(b, nh, nc, dh, ds)``."""
    b, nh, s = cum.shape
    total = cum.reshape(b, nh, s // chunk, chunk)[..., -1]
    r = torch.zeros_like(u[:, :, 0]) if dfinal is None else dfinal.to(u)
    out = [None] * u.shape[2]
    for c in reversed(range(u.shape[2])):
        out[c] = r
        r = u[:, :, c] + torch.exp(total[:, :, c])[..., None, None] * r
    return torch.stack(out, dim=2)


def ssd_bwd_chunk(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                  dy: torch.Tensor, cum: torch.Tensor, dcum: torch.Tensor,
                  dcp: torch.Tensor, chunk: int = 128
                  ) -> tuple[torch.Tensor, ...]:
    """Plain twin of K4-bwd's third pass (``ssd_bwd_chunk_kernel``), the
    intra-chunk terms, every chunk at once.  Per head, ``G = C B^T`` (once
    per group), ``P_tj = dy_t . x_j``, ``R = P D``, ``M = G R`` where
    ``cum_t - cum_j <= 0``; then ``dx_j = sum_t G_tj D_tj dy_t``, dcum +=
    ``rowsum(M) - colsum(M)``, and with ``R_s`` the sum of R over a
    slice's heads, the slice's ``dB = R_s^T C`` and dC += ``R_s B``.

    ``dcum`` and ``dcp`` are the first pass's.  Returns ``(dx (b, s, nh,
    dh), dcum (b, nh, s), dbp, dcp (b, s, g, slices, ds))``."""
    b, s, nh, dh = x.shape
    g = bmat.shape[2]
    xk, dyk = _chunks(x, chunk), _chunks(dy, chunk)
    bk, ck = _chunks(bmat, chunk), _chunks(cmat, chunk)
    cumk = cum.unflatten(2, (s // chunk, chunk))              # (b, nh, nc, L)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    logdec = cumk[..., :, None] - cumk[..., None, :]          # cum_t - cum_j
    dec = torch.where(causal, torch.exp(torch.clamp(logdec, max=0.0)), 0.0)
    gmat = torch.einsum("bctks,bcjks->bkctj", ck, bk)         # per group
    gmat = torch.repeat_interleave(gmat, nh // g, dim=1)
    r = torch.einsum("bcthd,bcjhd->bhctj", dyk, xk) * dec
    m = torch.where(logdec <= 0, gmat * r, 0.0)
    dx = torch.einsum("bhctj,bcthd->bcjhd", gmat * dec, dyk)
    rs = _by_slice(r, g, 1)                                   # (b, g, n, ...)
    dbp = torch.einsum("bknctj,bctks->bcjkns", rs, ck)
    dcp = dcp + torch.einsum("bknctj,bcjks->bctkns", rs, bk).flatten(1, 2)
    dcum = dcum + (m.sum(-1) - m.sum(-2)).flatten(2)
    return dx.reshape(b, s, nh, dh), dcum, dbp.flatten(1, 2), dcp


def ssd_bwd_state_terms(x: torch.Tensor, bmat: torch.Tensor,
                        cum: torch.Tensor, s_prev: torch.Tensor,
                        s_fin: torch.Tensor, dsn: torch.Tensor,
                        dx: torch.Tensor, dcum: torch.Tensor,
                        dbp: torch.Tensor, chunk: int = 128
                        ) -> tuple[torch.Tensor, ...]:
    """Plain twin of K4-bwd's fourth pass (``ssd_bwd_state_terms_kernel``):
    the leaving state's terms, from the second pass's ``dsn`` (the
    gradient into each chunk's leaving state ``S'``), then da.  Per head,
    with ``w_j = e^{T - cum_j}``: dx += ``w_j dS' B_j``, the slice's dB +=
    ``(w_j x_j) dS'`` summed over its heads, dcum -= ``x_j . (w_j dS'
    B_j)`` and += ``<dS', S'>`` at the chunk's last step; ``da`` is dcum's
    reverse cumsum within the chunk (in f64).

    ``dx``, ``dcum`` and ``dbp`` are the third pass's.  Returns ``(dx (b,
    s, nh, dh), da (b, s, nh), dbp (b, s, g, slices, ds))``."""
    b, s, nh, dh = x.shape
    g = bmat.shape[2]
    xk = _chunks(x, chunk)
    bkh = torch.repeat_interleave(_chunks(bmat, chunk), nh // g, dim=3)
    cumk = cum.unflatten(2, (s // chunk, chunk))              # (b, nh, nc, L)
    w = torch.exp(cumk[..., -1:] - cumk).permute(0, 2, 3, 1)  # (b, nc, L, nh)
    dxi = torch.einsum("bcjhs,bhcds->bcjhd", bkh, dsn) * w[..., None]
    dbi = torch.einsum("bcjhd,bhcds->bcjhs", xk * w[..., None], dsn)
    s_out = torch.cat([s_prev[:, :, 1:], s_fin[:, :, None]], dim=2)
    dcum = dcum.unflatten(2, (s // chunk, chunk)) \
        - (xk * dxi).sum(-1).permute(0, 3, 1, 2)
    dcum[..., -1] += (dsn * s_out).sum((-2, -1))
    da = _reverse_cumsum(dcum).permute(0, 2, 3, 1).reshape(b, s, nh)
    return (dx + dxi.reshape(b, s, nh, dh), da,
            dbp + _by_slice(dbi, g, 3).flatten(1, 2))


def ssd_scan_bwd_by_pass(x, a, bmat, cmat, cum, s_prev, s_fin, dy, dfinal,
                         chunk: int = 128) -> tuple[torch.Tensor, ...]:
    """``ssd_scan_bwd``'s ``(dx, da, dbmat, dcmat)`` from K4-bwd's five
    pass twins in the card's order: ``ops.SSDScan``'s backward off the
    card.  ``ssd_scan_bwd``, the closed form, is what it is held to."""
    u, dcp, dcum = ssd_bwd_chunk_states(dy, cmat, cum, s_prev, chunk)
    dsn = ssd_bwd_state_pass(cum, u, dfinal, chunk)
    dx, dcum, dbp, dcp = ssd_bwd_chunk(x, bmat, cmat, dy, cum, dcum, dcp,
                                       chunk)
    dx, da, dbp = ssd_bwd_state_terms(x, bmat, cum, s_prev, s_fin, dsn, dx,
                                      dcum, dbp, chunk)
    return (dx, da, *ssd_bwd_slice_sum(dbp, dcp))


def ssd_bwd_slice_sum(dbp: torch.Tensor, dcp: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K4-bwd's last pass (``ssd_bwd_slice_sum_kernel``): the
    slices' partial ``dbp, dcp (b, s, g, slices, ds)`` summed -> ``(dbmat,
    dcmat (b, s, g, ds))``."""
    return dbp.sum(3), dcp.sum(3)

"""K3's gradient on the CPU: the plain twin of K3-bwd
(``ref.flash_attention_bwd``) and ``ops.FlashAttention`` against
``jax.vjp`` of the reference's attention oracle
(``repro.kernels.ref.attention``), within 1e-5 in f32.

Cases: causal, sliding window, GQA, MQA, non-causal with sq != skv
(whisper's cross-attention), a ragged last kv block, q_offset > 0 and every
head dim the kernel takes (32, 64, 96, 112, 128).  Also: the forward's lse against ``logsumexp`` of the logits, the
Function's forward bit-equal to the no-grad ``ops.flash_attention``, the
gradient through remat's recompute, and zero gradients for rows that see
no key.  The card's kernel is held to the same twin in
``tests/test_torch_cuda.py``.  Last, the SSD scan's card branch wired
through ``SSDScan`` (the device check stubbed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as r_ref
from repro_torch.kernels import flash_attention_bwd, ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)

#: (b, hq, hkv, sq, skv, dh, causal, window, q_offset)
CASES = {
    "causal": (2, 4, 4, 80, 80, 32, True, None, 0),
    "window_gqa": (1, 6, 2, 150, 150, 64, True, 40, 0),
    "gqa_dh64": (2, 4, 2, 64, 64, 64, True, None, 0),
    "noncausal_cross": (2, 4, 4, 24, 150, 32, False, None, 0),
    "noncausal_ragged_self": (1, 4, 2, 100, 100, 64, False, None, 0),
    "q_offset": (2, 4, 2, 20, 130, 32, True, None, 110),
    "q_offset_window": (1, 4, 2, 33, 200, 64, True, 50, 167),
    "mqa_dh128": (1, 6, 1, 70, 70, 128, True, None, 0),
    "window_dh96": (1, 4, 2, 90, 90, 96, True, 30, 0),
    "q_offset_dh112": (1, 4, 2, 20, 100, 112, True, None, 80),
    "cross_dh128": (1, 2, 2, 24, 70, 128, False, None, 0),
}


def _inputs(case, seed=0):
    b, hq, hkv, sq, skv, dh = CASES[case][:6]
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh),
                      (b, hq, sq, dh))]


def _t(a, grad=False):
    return torch.from_numpy(a).requires_grad_(grad)


def _jax_vjp(q, k, v, do, causal, window, q_offset):
    def f(q, k, v):
        return r_ref.attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)

    out, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_twin_and_function_match_jax_vjp(case):
    causal, window, q_offset = CASES[case][6:]
    q, k, v, do = _inputs(case)
    out_ref, grads_ref = _jax_vjp(q, k, v, do, causal, window, q_offset)

    o, lse = ref.flash_attention(_t(q), _t(k), _t(v), causal, window,
                                 q_offset, return_lse=True)
    np.testing.assert_allclose(o.numpy(), out_ref, **TOL)
    twin = ref.flash_attention_bwd(_t(q), _t(k), _t(v), o, lse, _t(do),
                                   causal, window, q_offset)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = ops.flash_attention(tq, tk, tv, causal, window, q_offset)
    out.backward(_t(do))
    for name, a, b, want in zip("qkv", twin, (tq.grad, tk.grad, tv.grad),
                                grads_ref):
        np.testing.assert_allclose(a.numpy(), want, err_msg=name, **TOL)
        np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=name)


@pytest.mark.parametrize("case", ["causal", "window_gqa", "q_offset"])
def test_lse_is_the_logsumexp_of_the_logits(case):
    b, hq, hkv, sq, skv, dh, causal, window, q_offset = CASES[case]
    q, k, v, _ = _inputs(case, seed=1)
    _, lse = ref.flash_attention(_t(q), _t(k), _t(v), causal, window,
                                 q_offset, return_lse=True)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    qg = q.reshape(b, hkv, hq // hkv, sq, dh).astype(np.float64)
    logits = np.einsum("bhgqd,bhkd->bhgqk", qg, k.astype(np.float64)) \
        / np.sqrt(dh)
    qpos = np.arange(sq)[:, None] + q_offset
    kpos = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = np.where(mask, logits, -np.inf)
    top = logits.max(-1, keepdims=True)
    want = (top + np.log(np.exp(logits - top).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want.reshape(b, hq, sq),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["causal", "noncausal_cross"])
def test_function_forward_is_bit_equal_to_the_serving_call(case):
    causal, window, q_offset = CASES[case][6:]
    q, k, v, _ = _inputs(case, seed=2)
    served = ops.flash_attention(_t(q), _t(k), _t(v), causal, window,
                                 q_offset)
    trained = ops.flash_attention(_t(q, True), _t(k), _t(v), causal, window,
                                  q_offset)
    assert served.grad_fn is None and trained.grad_fn is not None
    np.testing.assert_array_equal(trained.detach().numpy(), served.numpy())
    with torch.no_grad():
        np.testing.assert_array_equal(
            ops.flash_attention(_t(q, True), _t(k), _t(v), causal, window,
                                q_offset).numpy(), served.numpy())


def test_gradient_through_checkpoint_recompute():
    """Under ``torch.utils.checkpoint`` (remat "full") the Function's saved
    tensors are recomputed and the gradient is unchanged."""
    causal, window, q_offset = CASES["window_gqa"][6:]
    q, k, v, do = _inputs("window_gqa", seed=3)
    grads = []
    for remat in (False, True):
        tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)

        def f(a, b, c):
            return ops.flash_attention(a * 1.0, b, c, causal, window,
                                       q_offset)

        out = (torch.utils.checkpoint.checkpoint(f, tq, tk, tv,
                                                 use_reentrant=False)
               if remat else f(tq, tk, tv))
        out.backward(_t(do))
        grads.append([t.grad for t in (tq, tk, tv)])
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_rows_that_see_no_key_get_zero_gradient():
    """Non-causal with a window, queries past the keys: rows 40.. see no
    key (lse = -inf) and keep zero gradients; the rest stay finite."""
    rng = np.random.RandomState(4)
    q = rng.randn(1, 2, 60, 32).astype(np.float32)
    k, v = (rng.randn(1, 1, 30, 32).astype(np.float32) for _ in range(2))
    do = rng.randn(*q.shape).astype(np.float32)
    o, lse = ref.flash_attention(_t(q), _t(k), _t(v), False, 10, 0,
                                 return_lse=True)
    assert torch.isinf(lse[..., 40:]).all() and torch.isfinite(
        lse[..., :39]).all()
    dq, dk, dv = ref.flash_attention_bwd(_t(q), _t(k), _t(v), o, lse, _t(do),
                                         False, 10, 0)
    assert (dq[..., 39:, :] == 0).all()
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all() and g.abs().max() > 0


def test_bf16_twin_returns_the_input_dtype():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs("gqa_dh64", seed=5))
    o, lse = ref.flash_attention(q, k, v, True, None, 0, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    grads = ref.flash_attention_bwd(q, k, v, o, lse, do, True, None, 0)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3


def test_backward_kernel_wrapper_refuses_what_it_does_not_take():
    q = torch.zeros(1, 2, 64, 80)
    kv = torch.zeros(1, 1, 64, 80)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="80"):
        flash_attention_bwd.flash_attention_bwd_cuda(q, kv, kv, q, lse, q)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd.flash_attention_bwd_cuda(
            q[..., :64].contiguous(), kv[..., :64].contiguous(),
            kv[..., :64].contiguous(), q[..., :64].contiguous(), lse,
            q[..., :64].contiguous())


def test_ssd_scan_raises_on_a_card_tensor_that_needs_a_gradient(monkeypatch):
    """On the card (the device check stubbed to take the card's branch), a
    scan whose input needs a gradient goes through ``SSDScan``: K4's passes
    once in the forward, K4-bwd once in the backward, with no fallback to
    the plain twin, so a K4-bwd that fails raises.  Under ``no_grad`` and
    on detached inputs the forward alone launches."""
    x = torch.zeros(1, 128, 2, 16, requires_grad=True)
    a = torch.zeros(1, 128, 2)
    bm = torch.zeros(1, 128, 1, 16)
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    calls = {"passes": 0, "bwd": 0, "scan": 0}

    def passes(x, a, bmat, cmat, chunk):
        calls["passes"] += 1
        return ref.ssd_passes(x, a, bmat, cmat, chunk)

    def bwd(*args):
        calls["bwd"] += 1
        return ref.ssd_scan_bwd(*args)

    def scan(*args, **kw):
        calls["scan"] += 1
        return ref.ssd_scan(*args, **kw)

    monkeypatch.setattr(ops._ssd, "ssd_passes_cuda", passes)
    monkeypatch.setattr(ops._ssd_bwd, "ssd_scan_bwd_cuda", bwd)
    monkeypatch.setattr(ops._ssd, "ssd_scan_cuda", scan)
    y, _ = ops.ssd_scan(x, a, bm, bm)
    y.sum().backward()
    assert calls == {"passes": 1, "bwd": 1, "scan": 0}
    assert x.grad is not None and x.grad.shape == x.shape

    def launch_failed(*args):
        raise RuntimeError("k4b launch failed")

    monkeypatch.setattr(ops._ssd_bwd, "ssd_scan_bwd_cuda", launch_failed)
    y, _ = ops.ssd_scan(x, a, bm, bm)
    with pytest.raises(RuntimeError, match="k4b"):
        y.sum().backward()
    with torch.no_grad():
        ops.ssd_scan(x, a, bm, bm)
    ops.ssd_scan(x.detach(), a, bm, bm)
    assert calls == {"passes": 2, "bwd": 1, "scan": 2}

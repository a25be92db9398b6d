"""granite-moe-1b-a400m's MoE layer on the card at its training shape: the
spread sentinel slots of ``models.mlp._dispatch`` against the token-0
dispatch restated in ``_moe_sentinel``.

Needs an NVIDIA GPU: the test carries the ``cuda`` marker and skips
without one.  This file imports neither JAX nor the reference package.
Run it on a card with

    python -m pytest -q -s -m cuda tests/test_torch_moe_cuda.py
"""
import pytest
import torch

from repro_torch import configs
from repro_torch.models import mlp

from _moe_sentinel import largest_run, pile_bound, rel_l2, token0_dispatch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the test runs at the card's "
                    "training shape")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spread_sentinels_match_token0_dispatch_on_card(card, monkeypatch):
    """t 8,192 (2 x 4096), 32 experts of 512, top-8, capacity 2,560, d
    1,024, bf16, a router skewed to 8 experts so that most slots are
    empty: the layer's output and x's gradient (the token gather's
    backward) within relative L2 2^-8 of the token-0 dispatch's, and no
    token in more than k + ceil(e cap / t) slots.  Prints whether each is
    bit for bit, and the spread dispatch against itself."""
    cfg = configs.get("granite-moe-1b-a400m").make_config()
    e, k, d, t = cfg.n_experts, cfg.top_k, cfg.d_model, 8192
    cap = mlp.capacity(cfg, t, False)
    assert (e, k, d, cap) == (32, 8, 1024, 2560)
    p = mlp.init_moe(cfg, torch.Generator(device=card).manual_seed(0),
                     dtype=torch.bfloat16)
    g = torch.Generator(device=card).manual_seed(1)
    x0 = torch.randn(2, t // 2, d, generator=g, device=card)
    ct = torch.randn(x0.shape, generator=g, device=card).to(torch.bfloat16)
    u = torch.randn(d, generator=g, device=card)
    u /= torch.linalg.vector_norm(u)
    x0 = (x0 + 4.0 * u).to(torch.bfloat16)
    with torch.no_grad():
        p.router.weight[:k] += u          # experts 0-7 gain ~4 in logit
    seen = {}

    def run(dispatch):
        def recording(eid, wgt, k_, e_, cap_):
            seen["tok"], seen["w"] = dispatch(eid, wgt, k_, e_, cap_)
            return seen["tok"], seen["w"]

        monkeypatch.setattr(mlp, "_dispatch", recording)
        x = x0.clone().requires_grad_(True)
        y, _ = mlp.apply_moe(cfg, p, x)
        y.backward(ct)
        torch.cuda.synchronize(card)
        return y.detach(), x.grad, seen["tok"], seen["w"]

    spread = mlp._dispatch
    y, gx, tok, w = run(spread)
    y2, gx2, _, _ = run(spread)
    y0, gx0, tok0, w0 = run(token0_dispatch)
    empty = float((w0 == 0).float().mean())
    print(f"\nempty slots {empty:.4f}; largest run of one token: token-0 "
          f"{largest_run(tok0, t)}, spread {largest_run(tok, t)} (bound "
          f"{pile_bound(k, e, cap, t)}); output rel L2 {rel_l2(y, y0):.3e}"
          f", bit for bit {torch.equal(y, y0)} (spread twice "
          f"{torch.equal(y, y2)}); x gradient rel L2 {rel_l2(gx, gx0):.3e}"
          f", bit for bit {torch.equal(gx, gx0)} (spread twice "
          f"{torch.equal(gx, gx2)})")
    assert empty > 0.5
    assert torch.equal(w, w0)
    assert largest_run(tok, t) <= pile_bound(k, e, cap, t)
    assert rel_l2(y, y0) <= 2 ** -8
    assert rel_l2(gx, gx0) <= 2 ** -8

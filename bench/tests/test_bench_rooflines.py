"""The roofline arithmetic and the model FLOPs, held to the bound column of
PERF.md's kernel table at its shapes, and the trace reduction on a
synthetic trace."""
from __future__ import annotations

import pytest

from bench.configs import model_flops
from bench.harness import cell as cell_mod
from bench.harness.peaks import H100_SXM
from bench.harness.trace import Trace, base_name
from bench.harness.work import Pass, live_pairs
from bench.metrics import (gemm_roofline, k3_roofline, k3bwd_roofline,
                           k4_roofline, k4bwd_roofline)

MS = 1e3


def test_k3_bounds_match_the_kernel_table():
    # granite-moe's training microbatch: q (2, 16, 4096, 64), k / v (2, 8)
    assert k3_roofline.call_bound_s(2, 16, 8, 4096, 4096, 64, None, 2,
                                    H100_SXM) * MS == pytest.approx(
        0.0695, abs=5e-5)
    # hymba's served prefill: global layer / SWA layer, (4, 25 / 5, 2048)
    assert k3_roofline.call_bound_s(4, 25, 5, 2048, 2048, 64, None, 2,
                                    H100_SXM) * MS == pytest.approx(
        0.0543, abs=5e-5)
    assert k3_roofline.call_bound_s(4, 25, 5, 2048, 2048, 64, 1024, 2,
                                    H100_SXM) * MS == pytest.approx(
        0.0407, abs=5e-5)


def test_k3bwd_bound_matches_the_kernel_table():
    assert k3bwd_roofline.call_bound_s(2, 16, 8, 4096, 4096, 64, None, 2,
                                       H100_SXM) * MS == pytest.approx(
        0.1738, abs=5e-5)
    # dh 32, (2, 8 / 2, 1000 x 1100), q_offset 100
    assert k3bwd_roofline.call_bound_s(2, 8, 2, 1000, 1100, 32, None, 2,
                                       H100_SXM, q_offset=100) * MS == \
        pytest.approx(0.0031, abs=5e-5)


def test_k4_bound_matches_the_kernel_table():
    # hymba's prefill: x (4, 2048, 50, 64), B / C (4, 2048, 1, 16); the
    # bytes bind (C B^T once per group, the products at split-TF32's rate)
    assert k4_roofline.call_bound_s(4, 2048, 50, 64, 16, 1, H100_SXM) * MS \
        == pytest.approx(0.06365, abs=5e-5)
    # mamba2's: x (4, 2048, 80, 64), B / C (4, 2048, 1, 128); the products
    assert k4_roofline.call_bound_s(4, 2048, 80, 64, 128, 1, H100_SXM) * MS \
        == pytest.approx(0.1640, abs=5e-5)


def test_k4bwd_bounds_match_the_kernel_table():
    # hymba's training microbatch: bytes bound; mamba2's: the products
    assert k4bwd_roofline.call_bound_s(2, 4096, 50, 64, 16, 1, H100_SXM) \
        * MS == pytest.approx(0.0997, abs=5e-5)
    assert k4bwd_roofline.call_bound_s(2, 4096, 80, 64, 128, 1, H100_SXM) \
        * MS == pytest.approx(0.3283, abs=5e-5)


def test_live_pairs():
    assert live_pairs(4, 4) == 10
    assert live_pairs(4, 4, True, 2) == 7
    assert live_pairs(4096, 4096, True, 1024) == 1024 * 1025 // 2 \
        + 3072 * 1024
    assert live_pairs(2, 3, False) == 6


@pytest.mark.parametrize("name,per_token", [
    ("granite-moe-1b-a400m", 1.06e9), ("hymba-1.5b", 3.41e9)])
def test_model_flops_per_token(name, per_token):
    cfg = cell_mod.load(f"{name}.train").config
    fwd = model_flops.model_flops(cfg, Pass(1, 4096, 4096, False)) / 4096
    assert fwd == pytest.approx(per_token, rel=0.01)
    train = model_flops.model_flops(cfg, Pass(1, 4096, 4096, True)) / 4096
    assert train == pytest.approx(3 * fwd)
    # a prefill computes the logits of the last row only
    last = model_flops.model_flops(cfg, Pass(1, 4096, 1, False)) / 4096
    assert fwd - last == pytest.approx(
        2 * cfg["d_model"] * cfg["vocab_size"] * 4095 / 4096)


def test_dense_products_leave_out_the_conv_and_the_scan():
    cfg = cell_mod.load("hymba-1.5b.train").config
    p = Pass(2, 256, 512, False)
    assert model_flops.forward_flops(cfg, p) == pytest.approx(
        model_flops.matmul_flops(cfg, p) + model_flops.attention_flops(cfg, p)
        + model_flops.scan_flops(cfg, p))
    assert model_flops.scan_flops(cfg, p) > 0
    granite = cell_mod.load("granite-moe-1b-a400m.train").config
    assert model_flops.scan_flops(granite, p) == 0


def _trace(kernels, host=()):
    """A Chrome trace: the window 0..100 us, kernels ``(name, t0, t1,
    corr)``, launches at ``t0 - 1`` inside host ops ``(name, t0, t1)``."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 0, "dur": 100, "tid": 1}]
    for name, t0, t1, corr in kernels:
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": t0,
                   "dur": t1 - t0, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunch",
                   "ts": t0 - 1, "dur": 0.5, "tid": 1,
                   "args": {"correlation": corr}})
    for name, t0, t1 in host:
        ev.append({"ph": "X", "cat": "cpu_op", "name": name, "ts": t0,
                   "dur": t1 - t0, "tid": 1})
    return Trace(ev)


def test_trace_busy_idle_and_names():
    k3 = "void repro_torch::(anonymous namespace)::flash_wgmma_kernel" \
         "<64, true>(repro_torch::FlashParams)"
    tr = _trace([(k3, 10, 30, 1), ("sm90_xmma_gemm_bf16bf16", 20, 40, 2),
                 ("void at::native::index_elementwise_kernel<128, 4>()",
                  60, 70, 3)],
                host=[("aten::mm", 5, 25), ("aten::index", 50, 65)])
    assert base_name(k3) == "flash_wgmma_kernel"
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(40e-6)        # 10..40 and 60..70
    assert tr.prefix_seconds(k3_roofline.PREFIXES) == pytest.approx(20e-6)
    assert tr.device_seconds(gemm_roofline.is_gemm) == pytest.approx(20e-6)
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::mm"] == pytest.approx(10e-6)       # 0..10
    assert gaps["aten::index"] == pytest.approx(20e-6)    # 40..60
    assert gaps["window end"] == pytest.approx(30e-6)
    assert tr.top_ops(1)[0][1] == pytest.approx(20e-6)


def test_a_share_is_none_without_its_kernels():
    from types import SimpleNamespace

    cfg = cell_mod.load("granite-moe-1b-a400m.train").config
    ctx = SimpleNamespace(trace=_trace([("sm90_xmma_gemm", 10, 20, 1)]),
                          traced=[Pass(1, 1, 1, False)], config=cfg,
                          peaks=H100_SXM)
    assert k3_roofline.read(ctx) is None
    assert k4_roofline.read(ctx) is None
    assert 0 < gemm_roofline.read(ctx) <= 100

"""The K1, K4 and K4-bwd wrappers' checks, on the CPU.

``kernel_matrix_cuda``, ``ssd_scan_cuda`` and ``ssd_scan_bwd_cuda`` raise on
a wrong dtype, shape, layout or device before anything is built or
launched.  This file imports neither JAX nor the reference package.
"""
import pytest
import torch

from repro_torch.kernels import build, rbf, ssd, ssd_bwd


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if the wrapper reaches the kernel build."""
    def refuse(name):
        raise AssertionError(f"built {name} before the checks raised")
    monkeypatch.setattr(build, "library", refuse)


def _bank(dtype=torch.float32, n=7, p=3, m=5, d=4):
    return (torch.zeros((n, d), dtype=dtype),
            torch.zeros((p, m, d), dtype=dtype), torch.ones((p,), dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_k1_refuses_other_dtypes_before_building(no_build, dtype,
                                                 monkeypatch):
    """A CPU tensor would be refused first, so the device test is passed
    over to reach the dtype check."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(TypeError, match="float32"):
        rbf.kernel_matrix_cuda(*_bank(dtype))


@pytest.mark.parametrize("bad", ["x_width", "gamma_len"])
def test_k1_refuses_mismatched_shapes_before_building(no_build, bad,
                                                      monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    x, sv, gamma = _bank()
    if bad == "x_width":
        x = torch.zeros((7, 3))
    elif bad == "gamma_len":
        gamma = torch.ones((2,))
    with pytest.raises(ValueError, match="shape"):
        rbf.kernel_matrix_cuda(x, sv, gamma)


def test_k1_refuses_a_strided_view_before_building(no_build, monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    x, sv, gamma = _bank()
    wide = torch.zeros((7, 8))
    with pytest.raises(ValueError, match="contiguous"):
        rbf.kernel_matrix_cuda(wide[:, ::2], sv, gamma)


def test_k1_refuses_cpu_tensors_before_building(no_build):
    with pytest.raises(ValueError, match="CUDA"):
        rbf.kernel_matrix_cuda(*_bank())


def test_k1_refuses_unknown_kinds_before_building(no_build):
    with pytest.raises(ValueError, match="kind"):
        rbf.kernel_matrix_cuda(*_bank(), kind="linear")


def test_k1_sech2_constants_are_cached():
    rbf.sech2_consts.cache_clear()
    first = rbf.sech2_consts(1.38, 0.02585, 1.0)
    assert rbf.sech2_consts(1.38, 0.02585, 1.0) is first
    assert rbf.sech2_consts.cache_info().hits == 1
    gamma0, v_scale, nvt = first
    assert gamma0 == pytest.approx(1.0 / (4.0 * 1.38**2 * 0.02585**2))
    assert (v_scale, nvt) == (1.0, pytest.approx(1.38 * 0.02585))


def _scan(dtype=torch.float32, b=1, s=64, nh=4, dh=16, g=2, ds=8):
    return (torch.zeros((b, s, nh, dh), dtype=dtype),
            torch.zeros((b, s, nh), dtype=dtype),
            torch.zeros((b, s, g, ds), dtype=dtype),
            torch.zeros((b, s, g, ds), dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_k4_refuses_other_dtypes_before_building(no_build, dtype,
                                                 monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_scan_cuda(*_scan(dtype), chunk=32)


@pytest.mark.parametrize("kw,match", [
    (dict(dh=32), "head dim"), (dict(nh=3), "groups"), (dict(ds=160), "state"),
])
def test_k4_refuses_unsupported_shapes_before_building(no_build, kw, match):
    with pytest.raises(ValueError, match=match):
        ssd.ssd_scan_cuda(*_scan(**kw), chunk=32)


@pytest.mark.parametrize("chunk", [16, 48, 256, 128])
def test_k4_refuses_chunks_it_cannot_run_before_building(no_build, chunk):
    """Chunks must be multiples of 32 up to 128 that divide s (s = 64 here,
    so 128 does not divide it)."""
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_scan_cuda(*_scan(), chunk=chunk)


def test_k4_refuses_mismatched_group_inputs_before_building(no_build,
                                                            monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    x, a, bm, cm = _scan()
    with pytest.raises(ValueError, match="cmat"):
        ssd.ssd_scan_cuda(x, a, bm, cm[:, :, :1].contiguous(), chunk=32)


def test_k4_refuses_a_misaligned_x_before_building(no_build, monkeypatch):
    """x is read 16 bytes at a time: a view one element (4 B) into its
    storage raises instead of being copied."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    x, a, bm, cm = _scan()
    shifted = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    assert shifted.data_ptr() % ssd.ALIGN
    with pytest.raises(ValueError, match="aligned"):
        ssd.ssd_scan_cuda(shifted, a, bm, cm, chunk=32)


def test_k4_refuses_cpu_tensors_before_building(no_build):
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_cuda(*_scan(), chunk=32)


def _grad_args(dtype=torch.float32, b=1, s=64, nh=4, dh=16, g=2, ds=8,
               chunk=32, **bad):
    """K4-bwd's arguments (x, a, B, C, cum, s_prev, s_fin, dy, dfinal), one
    replaced by ``bad``."""
    x, a, bm, cm = _scan(dtype, b, s, nh, dh, g, ds)
    args = dict(x=x, a=a, bmat=bm, cmat=cm,
                cum=torch.zeros((b, nh, s), dtype=dtype),
                s_prev=torch.zeros((b, nh, s // chunk, dh, ds), dtype=dtype),
                s_fin=torch.zeros((b, nh, dh, ds), dtype=dtype),
                dy=torch.zeros_like(x),
                dfinal=torch.zeros((b, nh, dh, ds), dtype=dtype))
    args.update(bad)
    return args


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_k4b_refuses_other_dtypes_before_building(no_build, dtype,
                                                  monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(TypeError, match="float32"):
        ssd_bwd.ssd_scan_bwd_cuda(**_grad_args(dtype), chunk=32)


@pytest.mark.parametrize("kw,match", [
    (dict(dh=32), "head dim"), (dict(nh=3), "groups"), (dict(ds=160), "state"),
])
def test_k4b_refuses_unsupported_shapes_before_building(no_build, kw, match):
    with pytest.raises(ValueError, match=match):
        ssd_bwd.ssd_scan_bwd_cuda(**_grad_args(**kw), chunk=32)


@pytest.mark.parametrize("chunk", [16, 48, 256, 128])
def test_k4b_refuses_chunks_it_cannot_run_before_building(no_build, chunk):
    with pytest.raises(ValueError, match="chunk"):
        ssd_bwd.ssd_scan_bwd_cuda(**_grad_args(), chunk=chunk)


@pytest.mark.parametrize("name,shape", [
    ("s_prev", (1, 4, 3, 16, 8)), ("cum", (1, 4, 32)), ("dy", (1, 64, 4, 8)),
    ("dfinal", (1, 4, 8, 16)), ("s_fin", (1, 2, 16, 8))])
def test_k4b_refuses_mismatched_saved_tensors_before_building(
        no_build, monkeypatch, name, shape):
    """The forward's scratch, the final state and the gradients must have
    the shapes the scan's inputs give them."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(ValueError, match=name):
        ssd_bwd.ssd_scan_bwd_cuda(**_grad_args(**{name: torch.zeros(shape)}),
                                  chunk=32)


def test_k4b_refuses_a_misaligned_dy_before_building(no_build, monkeypatch):
    """dy is read 16 bytes at a time, as x is."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    args = _grad_args()
    dy = args["dy"]
    args["dy"] = torch.zeros(dy.numel() + 1)[1:].view(dy.shape)
    with pytest.raises(ValueError, match="dy must be 16-byte aligned"):
        ssd_bwd.ssd_scan_bwd_cuda(**args, chunk=32)


def test_k4b_refuses_cpu_tensors_before_building(no_build):
    with pytest.raises(ValueError, match="CUDA"):
        ssd_bwd.ssd_scan_bwd_cuda(**_grad_args(), chunk=32)

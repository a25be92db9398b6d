"""The K3 wrapper's checks, on the CPU.

``flash_attention_cuda`` picks its kernel by dtype (bf16: the tensor-core
kernel, f32: the CUDA-core kernel) and raises on what neither takes before
anything is built.  This file imports neither JAX nor the reference
package.
"""
import pytest
import torch

from repro_torch.kernels import build, flash_attention, ops


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if the wrapper reaches the kernel build."""
    def refuse(name):
        raise AssertionError(f"built {name} before the checks raised")
    monkeypatch.setattr(build, "library", refuse)


def _qkv(dtype, dh=64, sq=16):
    q = torch.zeros((1, 4, sq, dh), dtype=dtype)
    k = torch.zeros((1, 2, sq, dh), dtype=dtype)
    return q, k, k.clone()


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_k3_wrapper_refuses_other_dtypes_before_building(no_build, dtype):
    with pytest.raises(TypeError, match="no flash attention kernel"):
        flash_attention.flash_attention_cuda(*_qkv(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [16, 48, 80, 256])
def test_k3_wrapper_refuses_other_head_dims_before_building(no_build, dtype,
                                                            dh):
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_cuda(*_qkv(dtype, dh))


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_k3_bf16_refuses_a_misaligned_view_before_building(no_build, which):
    """TMA needs 16-byte aligned bases: a view one element (2 B) into its
    storage raises instead of being copied."""
    q, k, v = _qkv(torch.bfloat16)
    t = {"q": q, "k": k, "v": v}[which]
    shifted = torch.zeros(t.numel() + 1, dtype=torch.bfloat16)[1:].view(t.shape)
    assert shifted.data_ptr() % flash_attention.TMA_ALIGN
    args = {"q": q, "k": k, "v": v, which: shifted}
    with pytest.raises(ValueError, match="aligned"):
        flash_attention.flash_attention_cuda(args["q"], args["k"], args["v"])


def test_k3_f32_takes_any_alignment_and_needs_a_card(no_build):
    """The f32 kernel reads through plain loads, so an unaligned view passes
    the alignment check and is refused only for lying on the CPU."""
    q, k, v = _qkv(torch.float32)
    shifted = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(shifted, k, v)


def test_k3_variant_counters_are_reported():
    counts = ops.launch_counts()
    for name in ("flash_attention", "flash_attention_bf16_wgmma",
                 "flash_attention_f32_cuda_cores"):
        assert name in counts

"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE [arXiv:2402.19173; hf].  The values of
``repro/configs/starcoder2_7b.py``."""
from repro_torch.configs.base import reduced_common
from repro_torch.models.common import ModelConfig

ARCH = "starcoder2-7b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
        d_ff=18432, vocab_size=49152, d_head=128,
        qkv_bias=True, out_bias=True, mlp_bias=True,
        norm="layernorm", act="gelu", rope_theta=1e5,
    )


def reduced() -> ModelConfig:
    return reduced_common(make_config())

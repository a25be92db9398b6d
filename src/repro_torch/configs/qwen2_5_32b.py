"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].  The values of
``repro/configs/qwen2_5_32b.py``."""
from repro_torch.configs.base import reduced_common
from repro_torch.models.common import ModelConfig

ARCH = "qwen2.5-32b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=27648, vocab_size=152064, d_head=128,
        qkv_bias=True, norm="rmsnorm", act="silu", rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return reduced_common(make_config())

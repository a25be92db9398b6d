"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].  The values of
``repro/configs/granite_moe_1b_a400m.py``."""
from repro_torch.configs.base import reduced_common
from repro_torch.models.common import ModelConfig

ARCH = "granite-moe-1b-a400m"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=512, vocab_size=49155, d_head=64,
        norm="rmsnorm", act="silu",
        n_experts=32, top_k=8,
    )


def reduced() -> ModelConfig:
    return reduced_common(make_config())

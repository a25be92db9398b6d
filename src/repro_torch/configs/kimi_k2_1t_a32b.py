"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 + 1 shared — trillion-param MoE
(paper-table) [arXiv:2501.kimi2; unverified].  The values of
``repro/configs/kimi_k2_1t_a32b.py``."""
from repro_torch.configs.base import reduced_common
from repro_torch.models.common import ModelConfig

ARCH = "kimi-k2-1t-a32b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=2048, vocab_size=163840, d_head=112,
        norm="rmsnorm", act="silu",
        n_experts=384, top_k=8, n_shared_experts=1,
        capacity_factor=1.0,
    )


def reduced() -> ModelConfig:
    return reduced_common(make_config())

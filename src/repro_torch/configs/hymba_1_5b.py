"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads, SWA everywhere
except 3 global layers [arXiv:2411.13676; hf].  The values of
``repro/configs/hymba_1_5b.py``."""
from repro_torch.configs.base import reduced_common
from repro_torch.models.common import ModelConfig

ARCH = "hymba-1.5b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab_size=32001, d_head=64,
        norm="rmsnorm", act="silu",
        window=1024, global_layers=(0, 15, 31),
        ssm_state=16, ssm_head_dim=64, ssm_expand=2,
    )


def reduced() -> ModelConfig:
    return reduced_common(make_config())

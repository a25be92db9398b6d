"""mamba2-2.7b [ssm]: 64L d_model=2560 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified].  The values of
``repro/configs/mamba2_2_7b.py``."""
from repro_torch.configs.base import reduced_common
from repro_torch.models.common import ModelConfig

ARCH = "mamba2-2.7b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="ssm",
        n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=50280,
        norm="rmsnorm", act="silu",
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    )


def reduced() -> ModelConfig:
    return reduced_common(make_config(), n_heads=0, n_kv_heads=0, d_ff=0)

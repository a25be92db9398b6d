"""granite-20b [dense]: 52L d_model=6144 48H (GQA kv=1, i.e. MQA)
d_ff=24576 vocab=49152 — llama-arch, code [arXiv:2405.04324; hf].  The values of
``repro/configs/granite_20b.py``."""
from repro_torch.configs.base import reduced_common
from repro_torch.models.common import ModelConfig

ARCH = "granite-20b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab_size=49152, d_head=128,
        norm="rmsnorm", act="silu",
    )


def reduced() -> ModelConfig:
    return reduced_common(make_config(), n_kv_heads=1)

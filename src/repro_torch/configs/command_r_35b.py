"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — GQA, no-bias, parallel attn+mlp block
[hf:CohereForAI/c4ai-command-r-v01; unverified].  The values of
``repro/configs/command_r_35b.py``."""
from repro_torch.configs.base import reduced_common
from repro_torch.models.common import ModelConfig

ARCH = "command-r-35b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22528, vocab_size=256000, d_head=128,
        norm="layernorm", act="silu", parallel_block=True,
        tie_embeddings=True, rope_theta=8e6,
    )


def reduced() -> ModelConfig:
    return reduced_common(make_config())

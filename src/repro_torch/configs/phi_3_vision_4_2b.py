"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (GQA kv=32, i.e. MHA)
d_ff=8192 vocab=32064 — phi3-mini backbone + CLIP frontend (STUB:
precomputed patch embeddings) [hf:microsoft/Phi-3-vision-128k-instruct; hf].  The values of
``repro/configs/phi_3_vision_4_2b.py``."""
from repro_torch.configs.base import reduced_common
from repro_torch.models.common import ModelConfig

ARCH = "phi-3-vision-4.2b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32064, d_head=96,
        norm="rmsnorm", act="silu",
        n_patches=576,
    )


def reduced() -> ModelConfig:
    return reduced_common(make_config(), n_kv_heads=4)

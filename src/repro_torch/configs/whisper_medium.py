"""whisper-medium [audio]: 24L d_model=1024 16H d_ff=4096 vocab=51865 —
enc-dec; conv frontend STUBBED to precomputed frame embeddings
(frames = seq_len/2, decoder tokens = seq_len/8) [arXiv:2212.04356;
unverified].  The values of
``repro/configs/whisper_medium.py``."""
from repro_torch.configs.base import reduced_common
from repro_torch.models.common import ModelConfig

ARCH = "whisper-medium"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=51865, d_head=64,
        norm="layernorm", act="gelu",
        n_enc_layers=24, enc_seq_divisor=2, dec_seq_divisor=8,
    )


def reduced() -> ModelConfig:
    return reduced_common(make_config(), n_kv_heads=4)

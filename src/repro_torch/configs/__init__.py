"""Architecture registry: ``--arch <id>`` -> config module.

Counterpart of ``repro/configs/__init__.py``: the reference's ten
architectures, one config module each, with the same values.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "starcoder2-7b": "starcoder2_7b",
    "granite-20b": "granite_20b",
    "qwen2.5-32b": "qwen2_5_32b",
    "command-r-35b": "command_r_35b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "hymba-1.5b": "hymba_1_5b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "mamba2-2.7b": "mamba2_2_7b",
    "whisper-medium": "whisper_medium",
}

ARCHS = tuple(_MODULES)

# long_500k needs sub-quadratic attention: SSM + hybrid (SWA) only.
SUBQUADRATIC = ("mamba2-2.7b", "hymba-1.5b")


def get(name: str):
    """Return the config module for an arch id."""
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def shapes_for(name: str) -> list[str]:
    """Assigned input shapes for this arch (incl. mandated skips)."""
    base = ["train_4k", "prefill_32k", "decode_32k"]
    if name in SUBQUADRATIC:
        base.append("long_500k")
    return base

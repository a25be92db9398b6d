"""Architecture registry: ``--arch <id>`` -> config module.

Counterpart of ``repro/configs/__init__.py``.  The reference registers ten
architectures; this slice of the port carries hymba-1.5b (the hybrid
family).  Asking for any other raises ``NotImplementedError`` ("not ported
yet"); the rest are queued in ROADMAP.md.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "hymba-1.5b": "hymba_1_5b",
}

#: The reference's architecture ids, ported or not.
ARCHS = ("starcoder2-7b", "granite-20b", "qwen2.5-32b", "command-r-35b",
         "kimi-k2-1t-a32b", "granite-moe-1b-a400m", "hymba-1.5b",
         "phi-3-vision-4.2b", "mamba2-2.7b", "whisper-medium")

PORTED = tuple(_MODULES)


def get(name: str):
    """Return the config module for an arch id."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {list(ARCHS)}")
    if name not in _MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; ported: {list(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")

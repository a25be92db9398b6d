"""Feed-forward layers: the gated dense MLP.

Counterpart of ``repro/models/mlp.py`` (``init_dense`` / ``apply_dense``).
The sort-based capacity MoE waits for the slice that ports the moe family.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import (
    Dense, ModelConfig, activation, dense_apply, dense_init,
)


class MLP(nn.Module):
    """Gated MLP: ``wd(act(wg x) * wu x)``."""

    def __init__(self, wg: Dense, wu: Dense, wd: Dense):
        super().__init__()
        self.wg, self.wu, self.wd = wg, wu, wd


def init_dense(cfg: ModelConfig, generator: torch.Generator,
               d_ff: int | None = None, dtype=torch.float32) -> MLP:
    f = d_ff or cfg.d_ff
    scale_o = 0.02 / (2 * cfg.n_layers) ** 0.5
    g, d = generator, cfg.d_model
    return MLP(dense_init(g, d, f, bias=cfg.mlp_bias, dtype=dtype),
               dense_init(g, d, f, bias=cfg.mlp_bias, dtype=dtype),
               dense_init(g, f, d, scale=scale_o, bias=cfg.mlp_bias,
                          dtype=dtype))


def apply_dense(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = activation(cfg, dense_apply(p.wg, x)) * dense_apply(p.wu, x)
    return dense_apply(p.wd, h)

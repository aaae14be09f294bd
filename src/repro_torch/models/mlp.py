"""Gated MLP blocks (SwiGLU / GeGLU / plain GELU), butterfly-replaceable."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.context import ContextLike
from repro_torch.models import common as cm


class MLP(nn.Module):
    """``up``/``gate``/``down`` projection sites (site keys ``mlp_up``,
    ``mlp_gate``, ``mlp_down``)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None,
                 site_specs: cm.SiteSpecs = None):
        super().__init__()
        E, F = cfg.d_model, cfg.d_ff
        kw = dict(site="mlp", generator=generator, site_specs=site_specs)
        self.up = cm.linear_module(cfg, E, F, site_key="mlp_up", **kw)
        self.down = cm.linear_module(cfg, F, E, site_key="mlp_down", **kw)
        if cfg.mlp_variant in ("swiglu", "geglu"):
            self.gate = cm.linear_module(cfg, E, F, site_key="mlp_gate",
                                         **kw)


def mlp_apply(cfg: ModelConfig, mlp: MLP, x: torch.Tensor,
              context: ContextLike = None) -> torch.Tensor:
    act = cm.act_fn(cfg.mlp_variant)
    up = cm.linear_apply(mlp.up, x, context)
    if hasattr(mlp, "gate"):
        h = act(cm.linear_apply(mlp.gate, x, context)) * up
    else:
        h = act(up)
    return cm.linear_apply(mlp.down, h, context)

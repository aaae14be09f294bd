"""Architecture registry of the port: ``smollm-135m``, its ``-smoke``
variant, and the ``-butterfly`` / ``-butterfly-smoke`` variants (the
paper's §3.2 replacement applied to the LM head and MLP projections)."""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import smollm_135m
from repro_torch.configs.base import ButterflyConfig, ModelConfig

ARCHS: Dict[str, ModelConfig] = {smollm_135m.CONFIG.name: smollm_135m.CONFIG}
SMOKES: Dict[str, ModelConfig] = {smollm_135m.CONFIG.name: smollm_135m.smoke()}


def butterfly_variant(cfg: ModelConfig, k_factor: float = 1.0,
                      sites=("lm_head", "mlp")) -> ModelConfig:
    """Paper-faithful §3.2 replacement (k = k_factor · log2 n) of the dense
    output head and MLP projections."""
    return cfg.with_(name=cfg.name + "-butterfly",
                     butterfly=ButterflyConfig(sites=tuple(sites),
                                               k_factor=k_factor))


def names() -> List[str]:
    return list(ARCHS)


def get(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name.endswith("-smoke") and name[:-6] in SMOKES:
        return SMOKES[name[:-6]]
    if name.endswith("-butterfly") and name[:-10] in ARCHS:
        return butterfly_variant(ARCHS[name[:-10]])
    if name.endswith("-butterfly-smoke") and name[:-16] in SMOKES:
        return butterfly_variant(SMOKES[name[:-16]]).with_(
            name=name[:-16] + "-butterfly-smoke")
    raise KeyError(f"unknown architecture {name!r}; known: {names()}")

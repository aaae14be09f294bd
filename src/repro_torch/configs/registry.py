"""Architecture registry of the port: the zoo's ten archs, their ``-smoke``
variants, and the ``-butterfly`` / ``-butterfly-smoke`` variants (the
paper's §3.2 replacement applied to the LM head and MLP projections).

Every name constructs, and the port builds, serves and trains each."""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (dbrx_132b, gemma3_27b, gemma_7b,
                                 internvl2_1b, mistral_large_123b,
                                 olmoe_1b_7b, recurrentgemma_2b,
                                 seamless_m4t_medium, smollm_135m,
                                 xlstm_125m)
from repro_torch.configs.base import ButterflyConfig, ModelConfig

_MODULES = (olmoe_1b_7b, dbrx_132b, smollm_135m, gemma3_27b, gemma_7b,
            mistral_large_123b, recurrentgemma_2b, xlstm_125m, internvl2_1b,
            seamless_m4t_medium)

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES: Dict[str, ModelConfig] = {m.CONFIG.name: m.smoke() for m in _MODULES}


def butterfly_variant(cfg: ModelConfig, k_factor: float = 1.0,
                      sites=("lm_head", "mlp")) -> ModelConfig:
    """Paper-faithful §3.2 replacement (k = k_factor · log2 n) of the dense
    output head and MLP projections. A tied head is untied: the sandwich
    replaces it, so the head gets weights of its own."""
    if cfg.tie_embeddings:
        cfg = cfg.with_(tie_embeddings=False)
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


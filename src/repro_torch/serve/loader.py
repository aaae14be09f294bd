"""Engine parameter loading: fresh init from a seed."""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.context import resolve_device
from repro_torch.models.lm import LM


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Union[str, torch.device, None] = None) -> LM:
    """A freshly initialised :class:`LM` on ``device`` (``None`` = cuda,
    raising without a card), drawn from a ``torch.Generator`` seeded with
    ``seed``."""
    dev = resolve_device(device)
    model = LM(cfg, generator=torch.Generator().manual_seed(seed))
    return model.to(dev)

"""Engine parameter loading: checkpoint restore or fresh init.

* :func:`init_params` — a freshly initialised :class:`LM` from a seed.
* :func:`restore_params` — the ``params`` subtree of the newest valid
  checkpoint in a :mod:`repro_torch.checkpoint` directory, in the
  reference's layout (the layout both packages' trainers write: a
  ``{"params": ..., "opt": ...}`` tree, layers stacked as ``unit``). Torn
  or corrupt checkpoints fall back to the next older valid one. The tree
  is what :meth:`ServeEngine.set_params` takes: it copies the weights and
  keeps the engine's truncation-index buffers, which checkpoints do not
  carry.
* :func:`load_for_serving` — restore when a directory is given and holds a
  valid checkpoint, else fresh init; returns an :class:`LM` on ``device``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint.checkpointing import load_latest
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


def _cast_like(template, tree):
    if isinstance(template, dict):
        return {k: _cast_like(v, tree[k]) for k, v in template.items()}
    if isinstance(template, list):
        return [_cast_like(t, a) for t, a in zip(template, tree)]
    return np.asarray(tree, template.dtype)


def restore_params(cfg: ModelConfig, directory: str, *,
                   step: Optional[int] = None
                   ) -> Tuple[Optional[int], Optional[Dict]]:
    """Model params of the newest valid checkpoint in ``directory`` (or of
    ``step``), as a reference-layout tree of host numpy arrays in the
    model's dtypes.

    Returns ``(step, params)``, or ``(None, None)`` when the directory holds
    no restorable checkpoint (every candidate torn, corrupt or absent). The
    template is the arch's own param tree, so a checkpoint missing one of
    its leaves fails its candidate and falls through to older ones.
    """
    model = LM(cfg, generator=torch.Generator().manual_seed(0))
    template = convert.to_jax_params(dict(model.named_parameters()))
    s, tree, _extra = load_latest(directory, {"params": template},
                                  step=step)
    if s is None:
        return None, None
    return s, _cast_like(template, tree["params"])


def load_for_serving(cfg: ModelConfig, checkpoint_dir: str = "", *,
                     seed: int = 0,
                     device: Union[str, torch.device, None] = None
                     ) -> Tuple[Optional[int], LM]:
    """The model for a :class:`~repro_torch.serve.engine.ServeEngine` on
    ``device``: fresh from ``seed``, with the newest valid checkpoint's
    weights copied in when ``checkpoint_dir`` is set and restorable.
    Returns ``(restored_step_or_None, model)``."""
    dev = resolve_device(device)
    model = init_params(cfg, seed=seed, device="cpu")
    step = None
    if checkpoint_dir:
        step, params = restore_params(cfg, checkpoint_dir)
        if params is not None:
            convert.load_jax_params(model, params)
    return step, model.to(dev)

"""Gradient compression with error feedback.

Counterpart of ``repro.optim.compression``: two codecs, each a
:class:`~repro_torch.optim.optimizer.GradientTransformation` that chains
into the optimizer before Adam (:func:`repro_torch.train.steps.
make_optimizer`):

* ``topk`` — keep the entries whose magnitude reaches the ``k``-th largest,
  ``k = max(1, int(ratio · size))`` (ties keep more than ``k``);
* ``int8`` — per-tensor symmetric int8 quantization, scale
  ``max|g| / 127 + 1e-12``, rounding half to even and clipping to ±127.

Each carries what it dropped in an error-feedback buffer (Stich et al.)
that is added to the next step's gradient, so compressed training still
converges. The transform is exact to compress → decompress on one device;
:func:`compression_stats` gives the bytes a compressed tensor would take
on a link. 0-d leaves pass through; frozen (``None``) and non-floating
leaves carry no buffer.

The threshold and the scale are statistics of a whole leaf, and the port
keeps a layer's weights per layer where the reference stacks them into
one ``unit`` leaf. ``group`` maps a leaf's name to the leaf it is a slice
of (:func:`repro_torch.convert.reference_key` for the LM's parameters):
the leaves of a group share one threshold or scale, computed over all of
them, so the port compresses as the reference does.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim.optimizer import (GradientTransformation, Tree, _map,
                                         _is_trainable)

__all__ = ["ErrorFeedbackState", "compress_gradients", "compression_stats"]


class ErrorFeedbackState(NamedTuple):
    error: Tree


def _topk_compress(gs: List[torch.Tensor], ratio: float
                   ) -> List[torch.Tensor]:
    """Keep the entries of the group ``gs`` whose magnitude reaches its
    ``k``-th largest."""
    if len(gs) == 1 and gs[0].ndim == 0:
        return gs
    mag = torch.cat([g.reshape(-1).abs() for g in gs]) if len(gs) > 1 \
        else gs[0].reshape(-1).abs()
    k = max(1, int(ratio * mag.numel()))
    thresh = torch.topk(mag, k, sorted=False).values.min()
    return [g * (g.abs() >= thresh) for g in gs]


def _int8_compress(gs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Symmetric int8 quantization of the group ``gs`` with one scale."""
    if len(gs) == 1 and gs[0].ndim == 0:
        return gs
    peak = gs[0].abs().max()
    for g in gs[1:]:
        peak = torch.maximum(peak, g.abs().max())
    scale = peak / 127.0 + 1e-12
    return [torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            .to(g.dtype) * scale for g in gs]


def compress_gradients(kind: str, ratio: float = 0.01,
                       group: Optional[Callable[[str], str]] = None
                       ) -> GradientTransformation:
    """Error-feedback compression transform; ``kind`` is ``"topk"`` or
    ``"int8"``; ``group`` as in the module docstring (``None``: each leaf
    alone)."""
    if kind not in ("topk", "int8"):
        raise ValueError(f"unknown gradient compression {kind!r}: expected "
                         f"'topk' or 'int8'")

    def codec(gs):
        return _topk_compress(gs, ratio) if kind == "topk" \
            else _int8_compress(gs)

    def init(params):
        return ErrorFeedbackState(error=_map(
            lambda p: torch.zeros_like(p) if _is_trainable(p) else None,
            params))

    def update(grads, state, params=None):
        summed = _map(lambda g, e: None if g is None or e is None
                      else g + e, grads, state.error)
        groups: Dict[str, List[str]] = {}
        for name, v in summed.items():
            if v is not None:
                groups.setdefault(group(name) if group else name,
                                  []).append(name)
        compressed = dict.fromkeys(summed)
        for names in groups.values():
            for name, c in zip(names, codec([summed[n] for n in names])):
                compressed[name] = c
        new_err = _map(lambda s, c: None if c is None else s - c, summed,
                       compressed)
        return compressed, ErrorFeedbackState(error=new_err)

    return GradientTransformation(init, update)


def compression_stats(kind: str, g: torch.Tensor, ratio: float = 0.01
                      ) -> Tuple[int, int]:
    """``(raw_bytes, wire_bytes)`` of one tensor: a top-k tensor sends each
    kept value with a 4-byte index, an int8 one its payload and a 4-byte
    scale."""
    raw = g.numel() * g.element_size()
    if kind == "topk":
        k = max(1, int(ratio * g.numel()))
        wire = k * (g.element_size() + 4)
    elif kind == "int8":
        wire = g.numel() + 4
    else:
        wire = raw
    return raw, wire

"""The paper's dense-layer replacement (§3.2): the butterfly "sandwich".

A dense ``n2 x n1`` layer ``W`` becomes ``J2ᵀ · W' · J1``: ``J1`` a
``k1 x n1`` truncated butterfly, ``W'`` a small dense ``k2 x k1`` core,
``J2ᵀ`` the transpose of a ``k2 x n2`` truncated butterfly. Counterpart of
``repro.core.layers``: a hashable :class:`ButterflySpec` (sizes and the
fixed truncation indices) plus the parameter tensors, applied by
:func:`butterfly_linear_apply`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

import torch

from repro_torch.core import butterfly as bf
from repro_torch.kernels import sandwich as ks

__all__ = ["ButterflySpec", "default_k", "make_spec",
           "butterfly_linear_apply"]


@dataclass(frozen=True)
class ButterflySpec:
    """Static configuration of one sandwich layer. The truncation index
    sets are fixed at init and never trained."""

    n_in: int
    n_out: int
    k_in: int
    k_out: int
    idx_in: Tuple[int, ...]
    idx_out: Tuple[int, ...]
    use_bias: bool = True
    jl_scale: bool = True

    @property
    def pad_in(self) -> int:
        return bf.padded_dim(self.n_in)

    @property
    def pad_out(self) -> int:
        return bf.padded_dim(self.n_out)

    @property
    def scale_in(self) -> float:
        return math.sqrt(self.pad_in / self.k_in) if self.jl_scale else 1.0

    @property
    def scale_out(self) -> float:
        return math.sqrt(self.pad_out / self.k_out) if self.jl_scale else 1.0


def default_k(n: int, k_factor: float = 1.0) -> int:
    """The paper's ``k = log2(n)``, scaled by ``k_factor``, in [1, n]."""
    k = max(1, int(round(k_factor * math.log2(max(n, 2)))))
    return min(k, n)


def make_spec(generator: Optional[torch.Generator], n_in: int, n_out: int,
              k_in: Optional[int] = None, k_out: Optional[int] = None,
              k_factor: float = 1.0, use_bias: bool = True) -> ButterflySpec:
    k_in = default_k(n_in, k_factor) if k_in is None else k_in
    k_out = default_k(n_out, k_factor) if k_out is None else k_out
    idx_in = bf.truncation_indices(generator, bf.padded_dim(n_in), k_in)
    idx_out = bf.truncation_indices(generator, bf.padded_dim(n_out), k_out)
    return ButterflySpec(n_in=n_in, n_out=n_out, k_in=k_in, k_out=k_out,
                         idx_in=idx_in, idx_out=idx_out, use_bias=use_bias)


def butterfly_linear_apply(spec: ButterflySpec,
                           params: Mapping[str, torch.Tensor],
                           x: torch.Tensor, *,
                           backend: str = "auto") -> torch.Tensor:
    """The sandwich along the last axis: (..., n_in) -> (..., n_out).

    ``params`` holds ``b_in``, ``core``, ``b_out``, optionally ``bias``, and
    optionally the int32 index tensors ``idx_in``/``idx_out`` (built from
    the spec when absent). Zero-padding to ``pad_in`` and slicing back to
    ``n_out`` happen inside :func:`repro_torch.kernels.sandwich.
    sandwich_forward`; the bias is added here.
    """
    if x.shape[-1] != spec.n_in:
        raise ValueError(f"expected last dim {spec.n_in}, got {x.shape[-1]}")
    idx = {}
    for key, val in (("idx_in", spec.idx_in), ("idx_out", spec.idx_out)):
        idx[key] = params[key] if key in params else torch.tensor(
            val, dtype=torch.int32, device=x.device)
    z = ks.sandwich_forward(
        x.contiguous(), params["b_in"], params["core"], params["b_out"],
        idx["idx_in"], idx["idx_out"], scale_in=spec.scale_in,
        scale_out=spec.scale_out, n_out=spec.n_out, backend=backend)
    if spec.use_bias and "bias" in params:
        z = z + params["bias"].to(x.dtype)
    return z

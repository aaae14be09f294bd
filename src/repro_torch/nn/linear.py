"""``nn.Module`` facades for a projection site: the butterfly sandwich
(:class:`ButterflyLinear`, counterpart of ``repro.nn.ButterflyLinear``) and
the plain dense matmul (:class:`DenseLinear`). Both initialise their own
parameters from a ``torch.Generator`` and take the execution backend per
call."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.core import butterfly as bf
from repro_torch.core import layers as blayers

__all__ = ["ButterflyLinear", "DenseLinear"]


def scaled_normal(generator: Optional[torch.Generator], shape, fan_in: int,
                  scale: float = 1.0) -> torch.Tensor:
    """``scale / sqrt(fan_in)`` times a standard normal (the reference's
    ``scaled_normal`` init)."""
    s = scale / math.sqrt(max(fan_in, 1))
    return s * torch.randn(shape, generator=generator)


class ButterflyLinear(nn.Module):
    """Drop-in dense-layer replacement ``(..., n_in) -> (..., n_out)``:
    the sandwich ``J2ᵀ · W' · J1`` with FJLT-initialised butterflies and a
    ``scaled_normal`` core (the reference's init for model sites).

    Parameters: ``b_in`` (p1, 2, pad_in), ``b_out`` (p2, 2, pad_out),
    ``core`` (k_out, k_in), ``bias`` (n_out,) when the spec has one. The
    truncation indices ride as int32 buffers, so they follow ``.to()``.
    """

    def __init__(self, spec: blayers.ButterflySpec, *,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, scale: float = 1.0):
        super().__init__()
        self.spec = spec
        self.b_in = nn.Parameter(
            bf.fjlt_weights(generator, spec.pad_in, dtype=dtype))
        self.b_out = nn.Parameter(
            bf.fjlt_weights(generator, spec.pad_out, dtype=dtype))
        self.core = nn.Parameter(scaled_normal(
            generator, (spec.k_out, spec.k_in), spec.k_in, scale).to(dtype))
        if spec.use_bias:
            self.bias = nn.Parameter(torch.zeros(spec.n_out, dtype=dtype))
        self.register_buffer(
            "idx_in", torch.tensor(spec.idx_in, dtype=torch.int32))
        self.register_buffer(
            "idx_out", torch.tensor(spec.idx_out, dtype=torch.int32))

    def forward(self, x: torch.Tensor, backend: str = "auto") -> torch.Tensor:
        params = {"b_in": self.b_in, "core": self.core, "b_out": self.b_out,
                  "idx_in": self.idx_in, "idx_out": self.idx_out}
        if self.spec.use_bias:
            params["bias"] = self.bias
        return blayers.butterfly_linear_apply(self.spec, params, x,
                                              backend=backend)


class DenseLinear(nn.Module):
    """``x @ w`` with ``w`` (n_in, n_out) in the reference's layout, cast to
    ``x``'s dtype at use."""

    def __init__(self, n_in: int, n_out: int, *,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, scale: float = 1.0):
        super().__init__()
        self.w = nn.Parameter(
            scaled_normal(generator, (n_in, n_out), n_in, scale).to(dtype))

    def forward(self, x: torch.Tensor, backend: str = "auto") -> torch.Tensor:
        return x @ self.w.to(x.dtype)

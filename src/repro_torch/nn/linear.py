"""``nn.Module`` facades for a projection site: the butterfly sandwich
(:class:`ButterflyLinear` and :class:`SandwichLinear`, counterparts of
``repro.nn.ButterflyLinear``/``SandwichLinear``) and the plain dense matmul
(:class:`DenseLinear`). Each module owns its parameters, drawn from a
``torch.Generator``. A :class:`ButterflyLinear` carries a default
execution context (``context=`` of ``create``/``from_dense``/the
constructor; the model sites' is their config's), and a per-call
``context=`` overrides it field by field, as the reference's does::

    layer = ButterflyLinear.create(gen, 300, 100)          # on the card
    y = layer(x)
    y_plain = layer(x, context="torch")                    # plain twins
    layer = ButterflyLinear.from_dense(gen, W, k_in=64, k_out=64)
    W_approx = layer.to_dense()                            # Prop. 3.1

The constructor ``ButterflyLinear(spec, generator=...)`` is the model
sites' init (a ``scaled_normal`` core); ``create`` and ``from_dense`` are
the reference's layer API (a kaiming-uniform core, or the core distilled
from ``W``).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Union

import torch
from torch import nn

from repro_torch.core import butterfly as bf
from repro_torch.core import layers as blayers
from repro_torch.kernels.context import (ContextLike, ExecutionContext,
                                         resolve_device, resolve_execution)

__all__ = ["ButterflyLinear", "SandwichLinear", "DenseLinear"]

Device = Union[str, torch.device, None]


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
    ``params`` (``b_in``, ``b_out``, ``core``, optionally ``bias``) takes
    the weights as given and draws nothing. ``context`` is the layer's
    default execution context (the config layer of the resolution order).
    """

    def __init__(self, spec: blayers.ButterflySpec, *,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, scale: float = 1.0,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 context: ContextLike = None):
        super().__init__()
        self.spec = spec
        self.context: Optional[ExecutionContext] = \
            ExecutionContext.coerce(context)
        if params is None:
            params = {
                "b_in": bf.fjlt_weights(generator, spec.pad_in, dtype=dtype),
                "b_out": bf.fjlt_weights(generator, spec.pad_out,
                                         dtype=dtype),
                "core": scaled_normal(generator, (spec.k_out, spec.k_in),
                                      spec.k_in, scale).to(dtype)}
            if spec.use_bias:
                params["bias"] = torch.zeros(spec.n_out, dtype=dtype)
        self.b_in = nn.Parameter(params["b_in"])
        self.b_out = nn.Parameter(params["b_out"])
        self.core = nn.Parameter(params["core"])
        if spec.use_bias:
            self.bias = nn.Parameter(params["bias"])
        self.register_buffer("idx_in", torch.tensor(
            spec.idx_in, dtype=torch.int32, device=self.b_in.device))
        self.register_buffer("idx_out", torch.tensor(
            spec.idx_out, dtype=torch.int32, device=self.b_in.device))

    # -- the reference's layer API ------------------------------------------

    @classmethod
    def create(cls, generator: Optional[torch.Generator], n_in: int,
               n_out: int, *, k_in: Optional[int] = None,
               k_out: Optional[int] = None, k_factor: float = 1.0,
               use_bias: bool = True, dtype: torch.dtype = torch.float32,
               device: Device = None,
               context: ContextLike = None) -> "ButterflyLinear":
        """A new layer on ``device`` (``None``: the card): truncation
        indices, FJLT butterflies and a kaiming-uniform core drawn from
        ``generator``. ``k_in``/``k_out`` default to the paper's ``k =
        log2(n)`` scaled by ``k_factor``; ``context`` is the layer's
        default execution context."""
        dev = resolve_device(device)
        spec = blayers.make_spec(generator, n_in, n_out, k_in=k_in,
                                 k_out=k_out, k_factor=k_factor,
                                 use_bias=use_bias)
        params = blayers.init_butterfly_linear(generator, spec, dtype=dtype)
        return cls(spec, params=params, context=context).to(dev)

    @classmethod
    def from_dense(cls, generator: Optional[torch.Generator], W, *,
                   bias=None, k_in: Optional[int] = None,
                   k_out: Optional[int] = None, k_factor: float = 1.0,
                   dtype: torch.dtype = torch.float32,
                   device: Device = None,
                   context: ContextLike = None) -> "ButterflyLinear":
        """Distil a dense ``W`` (n_out x n_in; a tensor or an array) into a
        sandwich on ``device`` (``None``: the card): Proposition 3.1's FJLT
        butterflies and core ``W' = J2 W J1ᵀ``, the replacement path for a
        pretrained layer. The core is computed on ``W``'s device, in
        float32. ``bias`` (n_out,) becomes the layer's bias; without one the
        layer has none. ``context`` is the layer's default execution
        context."""
        dev = resolve_device(device)
        W = torch.as_tensor(W)
        n_out, n_in = W.shape
        spec = blayers.make_spec(generator, n_in, n_out, k_in=k_in,
                                 k_out=k_out, k_factor=k_factor,
                                 use_bias=bias is not None)
        params = blayers.init_from_dense(generator, spec, W, dtype=dtype)
        if bias is not None:
            params["bias"] = torch.as_tensor(bias).to(W.device, dtype)
        return cls(spec, params=params, context=context).to(dev)

    @property
    def n_in(self) -> int:
        return self.spec.n_in

    @property
    def n_out(self) -> int:
        return self.spec.n_out

    def param_count(self) -> int:
        """Trainable parameters (against ``n_in·n_out + n_out`` dense)."""
        return blayers.param_count(self.spec)

    def dense_param_count(self) -> int:
        return blayers.dense_param_count(self.spec.n_in, self.spec.n_out,
                                         self.spec.use_bias)

    def params(self) -> dict:
        """The weights by the reference's names (``b_in``, ``b_out``,
        ``core``, ``bias`` when the spec has one)."""
        out = {"b_in": self.b_in, "b_out": self.b_out, "core": self.core}
        if self.spec.use_bias:
            out["bias"] = self.bias
        return out

    def to_dense(self) -> torch.Tensor:
        """The dense (n_out x n_in) equivalent, without the bias."""
        return blayers.butterfly_linear_materialize(self.spec, self.params())

    def forward(self, x: torch.Tensor,
                context: ContextLike = None) -> torch.Tensor:
        """The sandwich on ``x``; ``context`` overrides the layer's default
        per call."""
        params = dict(self.params(), idx_in=self.idx_in,
                      idx_out=self.idx_out)
        return blayers.butterfly_linear_apply(
            self.spec, params, x,
            context=resolve_execution(context, default=self.context))


class SandwichLinear(ButterflyLinear):
    """The sandwich with explicit core sizes ``(k_in, k_out)``, for call
    sites that tune the core directly (paper §5.1) instead of taking the
    ``k = log2(n)`` default."""

    @classmethod
    def create(cls, generator: Optional[torch.Generator], n_in: int,
               n_out: int, k_in: Optional[int] = None,
               k_out: Optional[int] = None, *, k_factor: float = 1.0,
               use_bias: bool = True, dtype: torch.dtype = torch.float32,
               device: Device = None,
               context: ContextLike = None) -> "SandwichLinear":
        if k_in is None or k_out is None:
            raise TypeError("SandwichLinear.create requires explicit k_in "
                            "and k_out (use ButterflyLinear for the paper's "
                            "log2(n) default)")
        return super().create(generator, n_in, n_out, k_in=int(k_in),
                              k_out=int(k_out), k_factor=k_factor,
                              use_bias=use_bias, dtype=dtype, device=device,
                              context=context)


class DenseLinear(nn.Module):
    """``x @ w`` with ``w`` (n_in, n_out) in the reference's layout, cast to
    ``x``'s dtype at use."""

    def __init__(self, n_in: int, n_out: int, *,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, scale: float = 1.0):
        super().__init__()
        self.w = nn.Parameter(
            scaled_normal(generator, (n_in, n_out), n_in, scale).to(dtype))

    def forward(self, x: torch.Tensor,
                context: ContextLike = None) -> torch.Tensor:
        return x @ self.w.to(x.dtype)

"""The paper's dense-layer replacement (§3.2): the butterfly "sandwich".

A dense ``n2 x n1`` layer ``W`` becomes ``J2ᵀ · W' · J1``: ``J1`` a
``k1 x n1`` truncated butterfly, ``W'`` a small dense ``k2 x k1`` core,
``J2ᵀ`` the transpose of a ``k2 x n2`` truncated butterfly. Counterpart of
``repro.core.layers``: a hashable :class:`ButterflySpec` (sizes and the
fixed truncation indices) plus the parameter tensors, applied by
:func:`butterfly_linear_apply`; the inits (:func:`init_butterfly_linear`,
:func:`init_from_dense`), the dense equivalent
(:func:`butterfly_linear_materialize`) and the parameter counts.

The reference's ``_selection_matrices`` (one-hot truncate and scatter
matrices, cached per spec) is not ported: it is the TPU kernel's way to
gather, and the port's kernels gather by index from the int32 index
tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core import butterfly as bf
from repro_torch.kernels import sandwich as ks
from repro_torch.kernels.context import ContextLike, resolve_execution
from repro_torch.runtime import butterfly_sharding as bsh

__all__ = ["ButterflySpec", "default_k", "make_spec",
           "init_butterfly_linear", "init_from_dense", "dense_core",
           "butterfly_linear_apply", "butterfly_linear_materialize",
           "param_count", "effective_param_count", "dense_param_count"]

Params = Dict[str, torch.Tensor]


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


def _kaiming_uniform(generator: Optional[torch.Generator], shape,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``U(-sqrt(1/fan_in), sqrt(1/fan_in))`` with ``fan_in = shape[1]``:
    PyTorch's ``nn.Linear`` default, the reference's core init."""
    bound = math.sqrt(1.0 / shape[1])
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((2 * u - 1) * bound).to(dtype)


def init_butterfly_linear(generator: Optional[torch.Generator],
                          spec: ButterflySpec,
                          dtype: torch.dtype = torch.float32) -> Params:
    """FJLT butterflies and a kaiming-uniform core (+ a zero bias when the
    spec has one), drawn from ``generator`` in that order, on the CPU."""
    params = {
        "b_in": bf.fjlt_weights(generator, spec.pad_in, dtype=dtype),
        "b_out": bf.fjlt_weights(generator, spec.pad_out, dtype=dtype),
        "core": _kaiming_uniform(generator, (spec.k_out, spec.k_in), dtype),
    }
    if spec.use_bias:
        params["bias"] = torch.zeros(spec.n_out, dtype=dtype)
    return params


def _factors(spec: ButterflySpec, b_in: torch.Tensor, b_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The truncated butterflies restricted to the real widths: ``J1``
    (k_in, n_in) and ``J2`` (k_out, n_out)."""
    J1 = bf.materialize_truncated(b_in, spec.idx_in, spec.jl_scale)
    J2 = bf.materialize_truncated(b_out, spec.idx_out, spec.jl_scale)
    return J1[:, :spec.n_in], J2[:, :spec.n_out]


def dense_core(spec: ButterflySpec, b_in: torch.Tensor, b_out: torch.Tensor,
               W: torch.Tensor) -> torch.Tensor:
    """The core ``J2 W J1ᵀ`` (k_out x k_in) that makes the sandwich with
    butterflies ``b_in``, ``b_out`` approximate ``W``, in float32."""
    J1, J2 = _factors(spec, b_in.float(), b_out.float())
    return J2 @ W.float() @ J1.T


def init_from_dense(generator: Optional[torch.Generator],
                    spec: ButterflySpec, W: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> Params:
    """Params that make the sandwich approximate a dense ``W`` (n_out x
    n_in), Proposition 3.1: FJLT butterflies and the core ``W' = J2 W
    J1ᵀ``, computed in float32 on ``W``'s device, then cast."""
    b_in = bf.fjlt_weights(generator, spec.pad_in).to(W.device)
    b_out = bf.fjlt_weights(generator, spec.pad_out).to(W.device)
    params = {"b_in": b_in.to(dtype), "b_out": b_out.to(dtype),
              "core": dense_core(spec, b_in, b_out, W).to(dtype)}
    if spec.use_bias:
        params["bias"] = torch.zeros(spec.n_out, dtype=dtype,
                                     device=W.device)
    return params


def butterfly_linear_apply(spec: ButterflySpec,
                           params: Mapping[str, torch.Tensor],
                           x: torch.Tensor, *,
                           context: ContextLike = None) -> torch.Tensor:
    """The sandwich along the last axis: (..., n_in) -> (..., n_out).

    ``params`` holds ``b_in``, ``core``, ``b_out``, optionally ``bias``, and
    optionally the int32 index tensors ``idx_in``/``idx_out`` (built from
    the spec when absent). Zero-padding to ``pad_in`` and slicing back to
    ``n_out`` happen inside :func:`repro_torch.kernels.sandwich.
    sandwich_forward`; the bias is added here. A context with a mesh shards
    the whole layer's rows (kernel and bias) over the mesh's data axes,
    with replicated weights and all-reduced weight gradients
    (:func:`repro_torch.runtime.butterfly_sharding.
    sharded_butterfly_linear_apply`).
    """
    if x.shape[-1] != spec.n_in:
        raise ValueError(f"expected last dim {spec.n_in}, got {x.shape[-1]}")
    ctx = resolve_execution(context)
    axes = bsh.sharded_route(ctx)
    if axes:
        return bsh.sharded_butterfly_linear_apply(spec, params, x,
                                                  context=ctx, axes=axes)
    return _local_linear_apply(spec, params, x, ctx)


def _local_linear_apply(spec: ButterflySpec,
                        params: Mapping[str, torch.Tensor], x: torch.Tensor,
                        ctx) -> torch.Tensor:
    """:func:`butterfly_linear_apply` on one device under a finalized
    context: no resolution, no mesh routing (a shard of a sharded region
    runs this)."""
    idx = {}
    for key, val in (("idx_in", spec.idx_in), ("idx_out", spec.idx_out)):
        idx[key] = params[key] if key in params else torch.tensor(
            val, dtype=torch.int32, device=x.device)
    z = ks._local_sandwich(
        x.contiguous(), params["b_in"], params["core"], params["b_out"],
        idx["idx_in"], idx["idx_out"], spec.scale_in, spec.scale_out,
        spec.n_out, ctx.local())
    if spec.use_bias and "bias" in params:
        z = z + params["bias"].to(x.dtype)
    return z


def butterfly_linear_materialize(spec: ButterflySpec,
                                 params: Mapping[str, torch.Tensor]
                                 ) -> torch.Tensor:
    """The dense (n_out x n_in) equivalent ``J2ᵀ W' J1`` of the sandwich,
    without the bias (tests and analysis)."""
    J1, J2 = _factors(spec, params["b_in"], params["b_out"])
    return J2.T @ params["core"] @ J1


def param_count(spec: ButterflySpec) -> int:
    """Trainable parameters of the sandwich (the stored weights)."""
    p1, p2 = bf.num_stages(spec.pad_in), bf.num_stages(spec.pad_out)
    n = 2 * spec.pad_in * p1 + 2 * spec.pad_out * p2 + spec.k_in * spec.k_out
    return n + (spec.n_out if spec.use_bias else 0)


def effective_param_count(spec: ButterflySpec) -> int:
    """Weights on a path to a kept output (Appendix F), both butterflies,
    plus the core and the bias."""
    return (bf.effective_param_count(spec.pad_in, spec.idx_in)
            + bf.effective_param_count(spec.pad_out, spec.idx_out)
            + spec.k_in * spec.k_out + (spec.n_out if spec.use_bias else 0))


def dense_param_count(n_in: int, n_out: int, use_bias: bool = True) -> int:
    return n_in * n_out + (n_out if use_bias else 0)

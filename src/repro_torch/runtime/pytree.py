"""ParamSpec trees: shapes, dtypes, logical axes and init rules in one place.

Counterpart of ``repro.runtime.pytree``. A tree is nested dicts, lists and
tuples with :class:`ParamSpec` leaves; from it come materialized tensors
(:func:`init_params`), shape-only tensors on the ``meta`` device that
allocate nothing (:func:`abstract_params`, the reference's
``ShapeDtypeStruct`` trees), counts, bytes and flat paths. Draws come from
a ``torch.Generator`` and differ from the reference's ``jax.random`` draws;
shapes, dtypes, counts, bytes and paths are the same. Leaves are visited in
the reference's order (``jax.tree_util``: dict keys sorted).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import butterfly as bf

PyTree = Any


def as_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """A ``torch.dtype`` from itself or its name (``"bfloat16"``)."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


@dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor.

    ``axes``: a logical axis name per dim (None: never sharded). ``init``:
    "normal", "scaled_normal" (``scale / sqrt(shape[fan_in_dim])``),
    "zeros", "ones", "fjlt" (butterfly stage weights (p, 2, n), possibly
    under stacked leading axes) or "embedding" (normal times ``scale``).
    ``dtype``: a ``torch.dtype`` or its name.
    """

    shape: Tuple[int, ...]
    dtype: Union[str, torch.dtype] = torch.float32
    axes: Tuple[Optional[str], ...] = ()
    init: str = "scaled_normal"
    scale: float = 1.0
    fan_in_dim: int = -1

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank != shape {self.shape} rank")

    @property
    def torch_dtype(self) -> torch.dtype:
        return as_dtype(self.dtype)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def _normal(generator, spec: ParamSpec, scale: float) -> torch.Tensor:
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32)
    return (scale * x).to(spec.torch_dtype)


def _init_one(generator: Optional[torch.Generator], spec: ParamSpec
              ) -> torch.Tensor:
    dt = spec.torch_dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt)
    if spec.init == "fjlt":
        n, lead = spec.shape[-1], spec.shape[:-3]
        reps = int(np.prod(lead)) if lead else 1
        ws = [bf.fjlt_weights(generator, n, dtype=dt) for _ in range(reps)]
        return torch.stack(ws).reshape(spec.shape)
    if spec.init in ("normal", "embedding"):
        return _normal(generator, spec, spec.scale)
    if spec.init == "scaled_normal":
        fan_in = spec.shape[spec.fan_in_dim]
        return _normal(generator, spec, spec.scale / math.sqrt(max(fan_in, 1)))
    raise ValueError(f"unknown init {spec.init!r}")


def _map(fn: Callable, tree: PyTree) -> PyTree:
    """``fn`` over the leaves, the tree's structure kept and its dicts'
    keys sorted, as ``jax.tree_util`` rebuilds them."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: PyTree) -> Iterator:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def init_params(generator: Optional[torch.Generator], specs: PyTree
                ) -> PyTree:
    """Materialize a ParamSpec tree into CPU tensors, each leaf drawn from
    ``generator`` in turn; leaves that are not specs pass through."""
    return _map(lambda s: _init_one(generator, s) if is_spec(s) else s,
                specs)


def abstract_params(specs: PyTree) -> PyTree:
    """The tree as tensors on the ``meta`` device: shapes and dtypes, no
    storage."""
    return _map(lambda s: torch.empty(s.shape, dtype=s.torch_dtype,
                                      device="meta") if is_spec(s) else s,
                specs)


def param_count(specs: PyTree) -> int:
    return sum(int(np.prod(s.shape)) for s in _leaves(specs) if is_spec(s))


def param_bytes(specs: PyTree) -> int:
    return sum(int(np.prod(s.shape)) * s.torch_dtype.itemsize
               for s in _leaves(specs) if is_spec(s))


def tree_paths(tree: PyTree) -> Dict[str, Any]:
    """Flatten a tree into a ``{'a/b/0': leaf}`` path map."""
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(f"{prefix}/{i}" if prefix else str(i), v)
        else:
            flat[prefix] = node

    rec("", tree)
    return flat

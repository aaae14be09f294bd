"""Core butterfly-network math (paper §3), in plain PyTorch.

A butterfly network over ``n = 2^p`` coordinates is a product of ``p``
sparse stage matrices ``B = B_{p-1} · ... · B_0``. Stage ``s`` connects
index ``i`` with its partner ``i XOR 2^s`` through a 2x2 gadget, stored as
two length-``n`` weight vectors stacked into ``(p, 2, n)``::

    (B_s x)[i] = a_s[i] * x[i] + b_s[i] * x[i ^ 2^s]

Counterpart of ``repro.core.butterfly``; ``torch.Generator`` replaces the
reference's ``jax.random`` keys, so random draws differ from the
reference's for the same seed (tests hand both the same numpy inputs).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "num_stages",
    "padded_dim",
    "stage_swap",
    "butterfly_apply",
    "butterfly_transpose_apply",
    "fjlt_weights",
    "truncation_indices",
    "truncate",
    "untruncate",
]


def num_stages(n: int) -> int:
    """Number of butterfly stages ``p = log2(n)`` for a power-of-two ``n``."""
    p = int(round(math.log2(n)))
    if 2**p != n:
        raise ValueError(f"butterfly dimension must be a power of two, got {n}")
    return p


def padded_dim(n: int) -> int:
    """Smallest power of two >= n (paper footnote 4)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def stage_swap(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Swap each element with its stage partner along the last axis:
    ``y[i] = x[i ^ stride]``."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    xs = x.reshape(*lead, n // (2 * stride), 2, stride)
    return xs.flip(-2).reshape(*lead, n)


def _check_weights(w: torch.Tensor) -> Tuple[int, int]:
    p, two, n = w.shape[-3:]
    if two != 2 or 2**p != n:
        raise ValueError(f"weights must have shape (log2 n, 2, n); got "
                         f"{tuple(w.shape)}")
    return p, n


def butterfly_apply(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``B x`` along the last axis of ``x``; ``w`` is (p, 2, n), stage 0
    acts first."""
    p, n = _check_weights(w)
    if x.shape[-1] != n:
        raise ValueError(f"x last dim {x.shape[-1]} != butterfly dim {n}")
    for s in range(p):
        x = w[s, 0] * x + w[s, 1] * stage_swap(x, 1 << s)
    return x


def butterfly_transpose_apply(w: torch.Tensor, x: torch.Tensor
                              ) -> torch.Tensor:
    """``Bᵀ x``: stages in reverse order, each ``a ⊙ x + swap(b ⊙ x)``."""
    p, n = _check_weights(w)
    if x.shape[-1] != n:
        raise ValueError(f"x last dim {x.shape[-1]} != butterfly dim {n}")
    for s in reversed(range(p)):
        x = w[s, 0] * x + stage_swap(w[s, 1] * x, 1 << s)
    return x


def _hadamard_signs(n: int) -> np.ndarray:
    """Per-stage self-coefficient signs of the normalized Hadamard
    transform: ``+1`` iff bit ``s`` of ``i`` is 0."""
    idx = np.arange(n)
    p = num_stages(n)
    signs = np.empty((p, n), dtype=np.float64)
    for s in range(p):
        signs[s] = 1.0 - 2.0 * ((idx >> s) & 1)
    return signs


def fjlt_weights(generator: Optional[torch.Generator], n: int,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Stage weights computing ``(1/sqrt(n)) · H · D``: the Walsh–Hadamard
    transform after a random ±1 diagonal ``D`` absorbed into stage 0
    (paper footnote 5). The result is orthogonal."""
    p = num_stages(n)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    a = _hadamard_signs(n) * inv_sqrt2
    b = np.full((p, n), inv_sqrt2)
    d = (torch.randint(0, 2, (n,), generator=generator).numpy() * 2 - 1
         ).astype(np.float64)
    a[0] = a[0] * d
    b[0] = b[0] * d[np.arange(n) ^ 1]
    return torch.from_numpy(np.stack([a, b], axis=1)).to(dtype)


def truncation_indices(generator: Optional[torch.Generator], n: int,
                       ell: int) -> Tuple[int, ...]:
    """``ell`` output coordinates drawn uniformly without replacement, sorted
    (fixed for the lifetime of the layer, §3.1)."""
    if ell > n:
        raise ValueError(f"truncation {ell} > dim {n}")
    idx = torch.randperm(n, generator=generator)[:ell]
    return tuple(sorted(int(i) for i in idx))


def truncate(x: torch.Tensor, idx: Sequence[int], n: int,
             jl_scale: bool = True) -> torch.Tensor:
    """Project onto the fixed coordinate subset, scaled by ``sqrt(n/ell)``."""
    ind = torch.as_tensor(idx, dtype=torch.long, device=x.device)
    y = x.index_select(-1, ind)
    if jl_scale:
        y = y * math.sqrt(n / len(idx))
    return y


def untruncate(y: torch.Tensor, idx: Sequence[int], n: int,
               jl_scale: bool = True) -> torch.Tensor:
    """Transpose of :func:`truncate`: scatter ``ell`` values into ``n``."""
    ind = torch.as_tensor(idx, dtype=torch.long, device=y.device)
    if jl_scale:
        y = y * math.sqrt(n / len(idx))
    out = y.new_zeros(y.shape[:-1] + (n,))
    out[..., ind] = y
    return out

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
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "num_stages",
    "padded_dim",
    "stage_swap",
    "butterfly_apply",
    "butterfly_apply_nonlinear",
    "butterfly_transpose_apply",
    "fjlt_weights",
    "identity_weights",
    "random_weights",
    "truncation_indices",
    "truncate",
    "untruncate",
    "materialize",
    "materialize_truncated",
    "effective_param_count",
    "effective_param_bound",
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


def tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form, the default of ``jax.nn.gelu`` (the exact
    erf form differs by up to ~4e-4)."""
    return F.gelu(x, approximate="tanh")


def butterfly_apply_nonlinear(w: torch.Tensor, x: torch.Tensor,
                              act: Callable[[torch.Tensor], torch.Tensor]
                              = tanh_gelu) -> torch.Tensor:
    """Butterfly with non-linear gates between stages (paper §7):
    ``x <- act(B_s x)`` after every stage but the last. Same parameters as
    the linear butterfly, in plain PyTorch (the reference computes it
    outside its kernels too)."""
    p, n = _check_weights(w)
    if x.shape[-1] != n:
        raise ValueError(f"x last dim {x.shape[-1]} != butterfly dim {n}")
    for s in range(p):
        x = w[s, 0] * x + w[s, 1] * stage_swap(x, 1 << s)
        if s < p - 1:
            x = act(x)
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
    if torch.get_default_device().type == "meta":
        # an abstract model (``repro_torch.launch.specs``) draws nothing
        return torch.empty(p, 2, n, dtype=dtype)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    a = _hadamard_signs(n) * inv_sqrt2
    b = np.full((p, n), inv_sqrt2)
    d = (torch.randint(0, 2, (n,), generator=generator).numpy() * 2 - 1
         ).astype(np.float64)
    a[0] = a[0] * d
    b[0] = b[0] * d[np.arange(n) ^ 1]
    return torch.from_numpy(np.stack([a, b], axis=1)).to(dtype)


def identity_weights(n: int, dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """Stage weights that make the butterfly the identity map."""
    w = torch.zeros(num_stages(n), 2, n, dtype=dtype)
    w[:, 0, :] = 1.0
    return w


def random_weights(generator: Optional[torch.Generator], n: int,
                   scale: Optional[float] = None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gaussian stage weights; the default scale ``1/sqrt(2)`` keeps each
    stage an isometry in expectation (every output mixes two inputs)."""
    if scale is None:
        scale = 1.0 / math.sqrt(2.0)
    return scale * torch.randn(num_stages(n), 2, n, generator=generator,
                               dtype=dtype)


def truncation_indices(generator: Optional[torch.Generator], n: int,
                       ell: int) -> Tuple[int, ...]:
    """``ell`` output coordinates drawn uniformly without replacement, sorted
    (fixed for the lifetime of the layer, §3.1)."""
    if ell > n:
        raise ValueError(f"truncation {ell} > dim {n}")
    idx = torch.randperm(n, generator=generator, device="cpu")[:ell]
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


# ---------------------------------------------------------------------------
# Dense materialization (oracles and analysis; O(n^2) memory)
# ---------------------------------------------------------------------------

def materialize(w: torch.Tensor) -> torch.Tensor:
    """The dense ``n x n`` matrix ``B`` with ``B @ x == butterfly_apply(w,
    x)``."""
    _, n = _check_weights(w)
    eye = torch.eye(n, dtype=w.dtype, device=w.device)
    return butterfly_apply(w, eye).T       # row j of the product is B·e_j


def materialize_truncated(w: torch.Tensor, idx: Sequence[int],
                          jl_scale: bool = True) -> torch.Tensor:
    """Dense ``ell x n`` matrix of the truncated butterfly ``T ∘ B``: row
    ``m`` is ``Bᵀ e_idx[m]``, the transposed butterfly on a one-hot row, so
    it costs O(ell · n log n) and never forms the ``n x n`` matrix."""
    _, n = _check_weights(w)
    ind = torch.as_tensor(idx, dtype=torch.long, device=w.device)
    rows = torch.zeros(len(ind), n, dtype=w.dtype, device=w.device)
    rows[torch.arange(len(ind), device=w.device), ind] = 1
    M = butterfly_transpose_apply(w, rows)
    if jl_scale:
        M = M * math.sqrt(n / len(idx))
    return M


# ---------------------------------------------------------------------------
# Parameter accounting (paper Appendix F)
# ---------------------------------------------------------------------------

def effective_param_count(n: int, idx: Sequence[int]) -> int:
    """Number of weights on a path from some input to a kept output, by
    backward reachability through the stages; Appendix F bounds it by
    ``2 n log2(ell) + 6 n``."""
    p = num_stages(n)
    alive = np.zeros(n, dtype=bool)
    alive[list(idx)] = True
    total = 0
    for s in reversed(range(p)):
        total += 2 * int(alive.sum())        # two weights into each node
        alive = alive | alive[np.arange(n) ^ (1 << s)]
    return total


def effective_param_bound(n: int, ell: int) -> int:
    """Appendix F upper bound ``2 n log2(ell) + 6 n``."""
    return int(2 * n * max(math.log2(max(ell, 2)), 1) + 6 * n)

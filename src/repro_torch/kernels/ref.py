"""Plain PyTorch oracles, counterparts of ``repro.kernels.ref``.

``sandwich_ref`` keeps the reference oracle's form — one-hot selection and
scatter matrices, everything in ``x``'s dtype — so tests can hold it
against the JAX oracle directly. The kernel's own plain twin, with the
kernel's precision points and index arrays, is
:func:`repro_torch.kernels.sandwich.sandwich_plain`.
"""

from __future__ import annotations

import torch

from repro_torch.core import butterfly as bf


def butterfly_ref(w: torch.Tensor, x: torch.Tensor,
                  transpose: bool = False) -> torch.Tensor:
    """``B x`` (or ``Bᵀ x``) over the last axis; ``w`` is (p, 2, n)."""
    if transpose:
        return bf.butterfly_transpose_apply(w, x)
    return bf.butterfly_apply(w, x)


def sandwich_ref(x: torch.Tensor, b_in: torch.Tensor, core: torch.Tensor,
                 b_out: torch.Tensor, sel_in: torch.Tensor,
                 sel_out: torch.Tensor, scale_in: float,
                 scale_out: float) -> torch.Tensor:
    """Oracle of the fused sandwich: ``sel_in`` (n1, k1) one-hot selection,
    ``sel_out`` (k2, n2) one-hot scatter, scales the JL normalizations."""
    dt = x.dtype
    h = bf.butterfly_apply(b_in.to(dt), x)
    h = (h @ sel_in.to(dt)) * torch.tensor(scale_in, dtype=dt)
    h = torch.einsum("...i,oi->...o", h, core.to(dt))
    z = (h @ sel_out.to(dt)) * torch.tensor(scale_out, dtype=dt)
    return bf.butterfly_transpose_apply(b_out.to(dt), z)

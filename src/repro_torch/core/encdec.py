"""Encoder–decoder butterfly network (paper §4) and the Theorem 1 apparatus.

Counterpart of ``repro.core.encdec``. The network is ``Ȳ = D · E · B · X``
with ``X (n × d)`` data in columns, ``B`` an ℓ × n truncated butterfly,
``E (k × ℓ)`` a dense encoder core, ``D (m × k)`` a dense decoder and the
loss ``||Ȳ − Y||_F²``. Theorem 1: with ``B`` fixed, every local minimum of
``(D, E)`` is global, with loss ``tr(YYᵀ) − Σ_{i∈[k]} λ_i(Σ(B))``.

``B X`` runs through the butterfly kernels (:mod:`repro_torch.kernels.
butterfly`), forward and backward; the dense products and the ``linalg``
calls are PyTorch's, as the reference leaves them to XLA. Random draws use
``torch.Generator``s and differ from the reference's for the same seed; the
tests hand the reference's spec and weights over through
:func:`repro_torch.convert.encdec_from_jax`.

:func:`train` updates a clone of the caller's params in place (the port's
optimizer is in place, the reference's ``train`` is pure), so the caller's
params are left as they were.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import butterfly as bf
from repro_torch.kernels import butterfly as kb
from repro_torch.kernels.context import ContextLike, resolve_device
from repro_torch.optim import optimizer as opt

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class EncDecSpec:
    n: int          # input dim (rows of X)
    m: int          # output dim (rows of Y)
    d: int          # number of data columns
    k: int          # bottleneck
    ell: int        # butterfly truncation (k <= ell <= m <= n)
    jl_scale: bool = True
    trunc_idx: Tuple[int, ...] = ()

    @property
    def pad_n(self) -> int:
        return bf.padded_dim(self.n)


def make_spec(generator: Optional[torch.Generator], n: int, d: int, k: int,
              ell: Optional[int] = None, m: Optional[int] = None,
              eps: float = 0.5) -> EncDecSpec:
    """ℓ defaults to the Proposition 4.1 prescription ``k log k + k/eps``."""
    m = n if m is None else m
    if ell is None:
        ell = min(n, max(k + 1, int(math.ceil(k * math.log2(max(k, 2))
                                              + k / eps))))
    idx = bf.truncation_indices(generator, bf.padded_dim(n), ell)
    return EncDecSpec(n=n, m=m, d=d, k=k, ell=ell, trunc_idx=idx)


def init_params(generator: Optional[torch.Generator], spec: EncDecSpec, *,
                device=None) -> Params:
    """FJLT butterfly, Gaussian ``E`` and ``D`` scaled by ``1/sqrt(ℓ)`` and
    ``1/sqrt(k)``, on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    B = bf.fjlt_weights(generator, spec.pad_n)
    E = torch.randn(spec.k, spec.ell, generator=generator) / math.sqrt(
        spec.ell)
    D = torch.randn(spec.m, spec.k, generator=generator) / math.sqrt(spec.k)
    return {"B": B.to(dev), "E": E.to(dev), "D": D.to(dev)}


def apply_B(spec: EncDecSpec, w: torch.Tensor, X: torch.Tensor, *,
            context: ContextLike = None) -> torch.Tensor:
    """``B X`` for column data ``X (n × d)`` -> (ℓ × d).

    The butterfly runs over the rows of the transposed data: one copy pads
    and transposes ``X`` into a contiguous ``(d, pad_n)`` tensor for the
    kernel (``F.pad`` of the transposed view writes it in one pass), and the
    kernel's output is truncated to the ℓ kept coordinates.
    """
    Xp = F.pad(X.T, (0, spec.pad_n - spec.n)).contiguous()   # (d, pad_n)
    H = kb.butterfly_apply(Xp, w, context=context)
    Ht = bf.truncate(H, spec.trunc_idx, spec.pad_n, spec.jl_scale)
    return Ht.T                                              # (ℓ, d)


def forward(spec: EncDecSpec, params: Params, X: torch.Tensor, *,
            context: ContextLike = None) -> torch.Tensor:
    Xt = apply_B(spec, params["B"], X, context=context)
    return params["D"] @ (params["E"] @ Xt)


def loss_fn(spec: EncDecSpec, params: Params, X: torch.Tensor,
            Y: torch.Tensor, *, context: ContextLike = None) -> torch.Tensor:
    Yb = forward(spec, params, X, context=context)
    return torch.sum(torch.square(Yb - Y))


# ---------------------------------------------------------------------------
# Theory: Σ(B), Theorem 1 prediction, closed-form optimum for fixed B
# ---------------------------------------------------------------------------

def _pinv(G: torch.Tensor) -> torch.Tensor:
    """Moore-Penrose with singular values below 1e-6 of the largest cut."""
    return torch.linalg.pinv(G, rtol=1e-6)


def sigma_B(spec: EncDecSpec, w: torch.Tensor, X: torch.Tensor,
            Y: torch.Tensor) -> torch.Tensor:
    """``Σ(B) = Y X̃ᵀ (X̃ X̃ᵀ)^+ X̃ Yᵀ`` with ``X̃ = B X`` (m × m, PSD). The
    pseudo-inverse gives the projection form when rank(X) < ℓ."""
    Xt = apply_B(spec, w, X)
    M = Y @ Xt.T
    return M @ _pinv(Xt @ Xt.T) @ M.T


def theorem1_loss(spec: EncDecSpec, w: torch.Tensor, X: torch.Tensor,
                  Y: torch.Tensor, k: Optional[int] = None
                  ) -> torch.Tensor:
    """Predicted loss at a local minimum with B fixed:
    ``tr(YYᵀ) − Σ_{i∈[k]} λ_i(Σ(B))``."""
    k = spec.k if k is None else k
    lam = torch.linalg.eigvalsh(sigma_B(spec, w, X, Y)).flip(-1)
    return torch.trace(Y @ Y.T) - torch.sum(lam[:k])


def optimal_DE(spec: EncDecSpec, w: torch.Tensor, X: torch.Tensor,
               Y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form global optimum of (D, E) for fixed B (Claim C.1 with
    I = [k]): ``D = U_k``, ``E = U_kᵀ Y X̃ᵀ (X̃X̃ᵀ)^+``, ``U_k`` the top-k
    eigenvectors of Σ(B). Eigenvector signs are the solver's: compare
    ``D @ E`` or the loss, not ``D`` and ``E`` alone."""
    Xt = apply_B(spec, w, X)
    Ginv = _pinv(Xt @ Xt.T)
    M = Y @ Xt.T
    _, U = torch.linalg.eigh(M @ Ginv @ M.T)
    Uk = U.flip(-1)[:, :spec.k]
    return Uk, Uk.T @ M @ Ginv


# ---------------------------------------------------------------------------
# Baselines (paper §5.2): PCA (= Δ_k) and FJLT+PCA (Proposition 4.1)
# ---------------------------------------------------------------------------

def pca_loss(X: torch.Tensor, Y: torch.Tensor, k: int) -> torch.Tensor:
    """``Δ_k = ||Y_k − Y||_F²`` from the singular values of ``Y``."""
    s = torch.linalg.svdvals(Y)
    return torch.sum(torch.square(s[k:]))


def sketch_rank_k(Xt: torch.Tensor, X: torch.Tensor, k: int) -> torch.Tensor:
    """Best rank-k approximation of ``X`` from the rows of ``Xt`` (Sarlós):
    ``[X Π]_k`` with Π the projection onto rowspace(Xt). Leading axes are a
    batch: one batched SVD each for ``(..., ℓ, d)`` and ``(..., n, ℓ)``."""
    _, _, Vt = torch.linalg.svd(Xt, full_matrices=False)     # (ℓ, d)
    XV = X @ Vt.mT                                          # (n, ℓ)
    U2, S2, V2t = torch.linalg.svd(XV, full_matrices=False)
    XVk = (U2[..., :k] * S2[..., None, :k]) @ V2t[..., :k, :]
    return XVk @ Vt


def fjlt_pca_loss(generator: Optional[torch.Generator], X: torch.Tensor,
                  k: int, ell: int) -> torch.Tensor:
    """``||J_k(X) − X||_F²`` with J an ℓ × n FJLT (Proposition 4.1
    baseline)."""
    n = X.shape[0]
    pad_n = bf.padded_dim(n)
    w = bf.fjlt_weights(generator, pad_n).to(X.device)
    idx = bf.truncation_indices(generator, pad_n, ell)
    spec = EncDecSpec(n=n, m=n, d=X.shape[1], k=k, ell=ell, trunc_idx=idx)
    Xk = sketch_rank_k(apply_B(spec, w, X), X, k)
    return torch.sum(torch.square(X - Xk))


# ---------------------------------------------------------------------------
# Training (paper §5.2 one-phase, §5.3 two-phase)
# ---------------------------------------------------------------------------

def train(spec: EncDecSpec, params: Params, X: torch.Tensor, Y: torch.Tensor,
          steps: int, lr: float = 1e-3, train_B: bool = True,
          log_every: int = 0, context: ContextLike = None
          ) -> Tuple[Params, list]:
    """Full-batch Adam on the reconstruction loss; returns (params, loss
    history), the history holding the loss before each logged step.

    ``train_B=False`` freezes the butterfly (phase 1 of two-phase
    learning). The reference zeroes B's gradient before a fresh Adam, whose
    update of an all-zero gradient is exactly zero; here B is left out of
    the optimizer and needs no gradient, so the numbers are the same and no
    backward kernel runs. Works on a clone: ``params`` is left unchanged.
    """
    params = {k: v.detach().clone() for k, v in params.items()}
    names = ("B", "E", "D") if train_B else ("E", "D")
    history = opt.fit(lambda: loss_fn(spec, params, X, Y, context=context),
                      {k: params[k] for k in names}, steps, lr,
                      log_every=log_every)
    return {k: v.detach() for k, v in params.items()}, history


def train_two_phase(spec: EncDecSpec, params: Params, X: torch.Tensor,
                    Y: torch.Tensor, steps1: int, steps2: int,
                    lr: float = 1e-3, log_every: int = 0,
                    context: ContextLike = None) -> Tuple[Params, list, list]:
    """§5.3: phase 1 trains (D, E) with B frozen at its FJLT init (Theorem 1
    makes local = global there); phase 2 fine-tunes all three."""
    params, h1 = train(spec, params, X, Y, steps1, lr=lr, train_B=False,
                       log_every=log_every, context=context)
    params, h2 = train(spec, params, X, Y, steps2, lr=lr, train_B=True,
                       log_every=log_every, context=context)
    return params, h1, h2

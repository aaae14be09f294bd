"""Learned butterfly sketches for low-rank decomposition (paper §6).

Counterpart of ``repro.core.sketch``. Setting (Indyk–Vakilian–Yuan,
NeurIPS'19): learn a sketch ``B (ℓ × n)`` from training matrices ``X_i``
minimizing ``Σ_i ||X_i − B_k(X_i)||_F²``, ``B_k(X)`` the best rank-k
approximation of X from the rows of ``BX`` (differentiable through
``torch.linalg.svd``). The paper structures ``B`` as a truncated butterfly
and learns its stage weights; the baselines are the learned and random
Clarkson–Woodruff sparse sketches, the learned dense-N variant and a
Gaussian sketch.

``B X`` runs through the butterfly kernels (:mod:`repro_torch.kernels.
butterfly`): one contiguous ``(..., d, pad_n)`` copy of the padded,
transposed data, one forward launch, and in training the backward kernel
without ``dx`` (the data needs no gradient). A training step stacks its
batch into one ``(batch·d, pad_n)`` call and batches the SVDs over the
matrices, where the reference maps over them with ``jax.vmap``.

Draws come from ``torch.Generator``s and differ from the reference's; the
tests carry the reference's draws over (``w0=``, ``pattern=``,
:func:`repro_torch.convert.sketch_from_jax`). The batch order is the
reference's, ``numpy.random.default_rng(0)`` per training run. Entry points
put their tensors on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import butterfly as bf
from repro_torch.core.encdec import sketch_rank_k
from repro_torch.kernels import butterfly as kb
from repro_torch.kernels.context import ContextLike, resolve_device
from repro_torch.optim import optimizer as opt

Device = Union[str, torch.device, None]
Matrices = Union[torch.Tensor, Sequence]


@dataclass(frozen=True)
class SketchSpec:
    n: int
    ell: int
    k: int
    trunc_idx: Tuple[int, ...] = ()
    jl_scale: bool = True

    @property
    def pad_n(self) -> int:
        return bf.padded_dim(self.n)


def make_spec(generator: Optional[torch.Generator], n: int, ell: int,
              k: int) -> SketchSpec:
    idx = bf.truncation_indices(generator, bf.padded_dim(n), ell)
    return SketchSpec(n=n, ell=ell, k=k, trunc_idx=idx)


# ---------------------------------------------------------------------------
# Sketch application and the rank-k reconstruction loss (IVY19 Algorithm 1)
# ---------------------------------------------------------------------------

def butterfly_sketch(spec: SketchSpec, w: torch.Tensor, X: torch.Tensor, *,
                     context: ContextLike = None) -> torch.Tensor:
    """``B X``: (..., n, d) -> (..., ℓ, d) through the truncated butterfly,
    one kernel call over every matrix's columns."""
    Xp = F.pad(X.mT, (0, spec.pad_n - spec.n)).contiguous()  # (.., d, pad_n)
    H = kb.butterfly_apply(Xp, w, context=context)
    return bf.truncate(H, spec.trunc_idx, spec.pad_n, spec.jl_scale).mT


def reconstruction_loss(X: torch.Tensor, Xt: torch.Tensor, k: int
                        ) -> torch.Tensor:
    """``||X − [X Π_rowspace(Xt)]_k||_F²`` per matrix (differentiable in
    ``Xt``); leading axes are a batch.

    A sketch with repeated zero singular values (a sparse sketch with an
    empty row) has an infinite SVD gradient, here as in the reference, and
    its learned values turn NaN. The reference's SVD then returns NaN where
    ``torch.linalg.svd`` on the CPU raises, so that error gives a NaN loss
    here, as there."""
    try:
        Xk = sketch_rank_k(Xt, X, k)
    except torch.linalg.LinAlgError:
        return Xt.sum(dim=(-2, -1)) * float("nan")
    return torch.sum(torch.square(X - Xk), dim=(-2, -1))


def best_rank_k_loss(X: torch.Tensor, k: int) -> torch.Tensor:
    s = torch.linalg.svdvals(X)
    return torch.sum(torch.square(s[..., k:]), dim=-1)


def test_error(sketch_fn: Callable[[torch.Tensor], torch.Tensor],
               Xs: Matrices, k: int) -> float:
    """``Err = E[||X − B_k(X)||²] − E[Δ_k]`` over a test set, one
    ``sketch_fn`` call per matrix."""
    errs, apps = [], []
    for X in Xs:
        errs.append(float(reconstruction_loss(X, sketch_fn(X), k)))
        apps.append(float(best_rank_k_loss(X, k)))
    return float(np.mean(errs) - np.mean(apps))


# ---------------------------------------------------------------------------
# Baseline sketches
# ---------------------------------------------------------------------------

def cw_pattern(generator: Optional[torch.Generator], n: int, ell: int,
               nnz_per_col: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """A random sparsity pattern: ``rows[i, j]``, the target row of column
    i's j-th nonzero, and its ±1 sign. Returns (rows (n, nnz) int,
    signs (n, nnz) float32)."""
    rows = torch.randint(0, ell, (n, nnz_per_col), generator=generator)
    signs = torch.randint(0, 2, (n, nnz_per_col), generator=generator)
    return rows.numpy(), (2 * signs - 1).numpy().astype(np.float32)


def sparse_sketch_matrix(rows: np.ndarray, values: torch.Tensor, ell: int
                         ) -> torch.Tensor:
    """The dense ℓ × n sketch of a pattern and its values; entries that
    share a ``(row, column)`` add up."""
    n, nnz = rows.shape
    r = torch.as_tensor(np.asarray(rows), dtype=torch.long,
                        device=values.device)
    cols = torch.arange(n, device=values.device)[:, None].expand(n, nnz)
    M = values.new_zeros((ell, n))
    return M.index_put((r, cols), values, accumulate=True)


def gaussian_sketch(generator: Optional[torch.Generator], n: int, ell: int,
                    *, device: Device = None) -> torch.Tensor:
    """ℓ × n with iid N(0, 1/ℓ) entries, on ``device`` (``None``: the
    card)."""
    dev = resolve_device(device)
    return (torch.randn(ell, n, generator=generator)
            / math.sqrt(ell)).to(dev)


# ---------------------------------------------------------------------------
# Training loops
# ---------------------------------------------------------------------------

def _stack(Xs: Matrices, dev: torch.device) -> torch.Tensor:
    """The training matrices as one float32 ``(t, n, d)`` tensor."""
    if torch.is_tensor(Xs):
        return Xs.to(dev, torch.float32)
    return torch.stack([torch.as_tensor(X, dtype=torch.float32)
                        for X in Xs]).to(dev)


def _fit(loss_of: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
         leaf: torch.Tensor, data: torch.Tensor, steps: int, lr: float,
         batch: int, log_every: int, step_times: Optional[list]
         ) -> Tuple[torch.Tensor, list]:
    """:func:`repro_torch.optim.optimizer.fit` on the batch mean of
    ``loss_of(leaf, Xb)``, each step's batch from ``default_rng(0)``'s
    ``choice`` without replacement. Updates ``leaf`` in place."""
    rng = np.random.default_rng(0)
    t = data.shape[0]

    def loss_fn():
        idx = rng.choice(t, size=min(batch, t), replace=False)
        Xb = data[torch.as_tensor(idx, device=data.device)]
        return torch.mean(loss_of(leaf, Xb))

    history = opt.fit(loss_fn, {"w": leaf}, steps, lr, log_every=log_every,
                      step_times=step_times)
    return leaf.detach(), history


def train_butterfly_sketch(spec: SketchSpec,
                           generator: Optional[torch.Generator],
                           Xs: Matrices, steps: int, lr: float = 1e-3,
                           batch: int = 1, log_every: int = 0, *,
                           w0: Optional[torch.Tensor] = None,
                           context: ContextLike = None, device: Device = None,
                           step_times: Optional[list] = None
                           ) -> Tuple[torch.Tensor, list]:
    """Learn the butterfly's stage weights on the empirical sketch loss.
    Starts from ``w0`` (copied) or FJLT weights drawn from ``generator``;
    returns ``(w, logged losses)``. Each step is one forward and one
    backward butterfly call over its whole batch; ``step_times`` collects
    each step's seconds (see :func:`_fit`)."""
    dev = resolve_device(device)
    data = _stack(Xs, dev)
    w = (w0.detach().clone() if w0 is not None
         else bf.fjlt_weights(generator, spec.pad_n)).to(dev, torch.float32)

    def loss_of(w, Xb):
        Xt = butterfly_sketch(spec, w, Xb, context=context)
        return reconstruction_loss(Xb, Xt, spec.k)

    return _fit(loss_of, w, data, steps, lr, batch, log_every, step_times)


def train_sparse_sketch(generator: Optional[torch.Generator], Xs: Matrices,
                        n: int, ell: int, k: int, steps: int,
                        lr: float = 1e-3, nnz_per_col: int = 1,
                        batch: int = 1, log_every: int = 0, *,
                        pattern: Optional[Tuple[np.ndarray, np.ndarray]]
                        = None, device: Device = None,
                        step_times: Optional[list] = None
                        ) -> Tuple[np.ndarray, torch.Tensor, list]:
    """IVY19: learn the values of a fixed CW pattern (or the dense-N
    variant, paper Figure 8, when ``nnz_per_col > 1``), starting from its
    signs. The pattern is ``pattern`` (rows, signs) or drawn from
    ``generator``. Returns ``(rows, values, logged losses)``."""
    dev = resolve_device(device)
    rows, signs = (pattern if pattern is not None
                   else cw_pattern(generator, n, ell, nnz_per_col))
    data = _stack(Xs, dev)
    values = torch.tensor(np.asarray(signs), dtype=torch.float32).to(dev)

    def loss_of(values, Xb):
        B = sparse_sketch_matrix(rows, values, ell)
        return reconstruction_loss(Xb, B @ Xb, k)

    values, history = _fit(loss_of, values, data, steps, lr, batch,
                           log_every, step_times)
    return np.asarray(rows), values, history

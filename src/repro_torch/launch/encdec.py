"""Entry point of the encoder–decoder experiments (paper §4, §5.2, §5.3).

    python -m repro_torch.launch.encdec [--device cpu] [--n N --d D --k K]
        [--steps S] [--steps2 S2] [--seed SEED]

Prints the rows of the reference's ``benchmarks/bench_theorem1.py``,
``bench_autoencoder.py`` and ``bench_two_phase.py`` under the same names and
``derived`` fields, one ``name,derived`` line each:

* ``theorem1/n{n}_k{k}``: the loss at the closed-form optimum of (D, E)
  against the Theorem 1 prediction;
* ``autoenc/{data}_k{k}``: PCA against FJLT+PCA against the closed-form
  butterfly against gradient descent on all of B, E, D;
* ``two_phase/k{k}``: the prediction, phase 1 (B frozen) and phase 2.

Without ``--n`` it runs the reference benches' own grids and sizes. With
``--n`` it runs one row of each kind on the MNIST-like stand-in
``synthetic_image_matrix(n, d, seed)``. The device defaults to the card;
float32 products run in full float32 (TF32 off, checked).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import encdec as ed
from repro_torch.data.synthetic import gaussian_lowrank, synthetic_image_matrix
from repro_torch.kernels.context import resolve_device

AUTOENC_KS = (1, 4, 8, 16, 32)
TWO_PHASE_KS = (4, 8, 16)
THEOREM1_SHAPES = ((48, 4), (96, 8), (128, 16))


def full_float32() -> None:
    """Turn TF32 off for float32 matmuls and convolutions, and check it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("float32 products must not run in TF32")


def theorem1_row(spec: ed.EncDecSpec, params: ed.Params,
                 X: torch.Tensor) -> Dict:
    """The loss at the closed-form optimum (D, E) for the frozen B against
    the Theorem 1 prediction (auto-encoder: Y = X)."""
    D, E = ed.optimal_DE(spec, params["B"], X, X)
    measured = float(ed.loss_fn(spec, dict(params, D=D, E=E), X, X))
    predicted = float(ed.theorem1_loss(spec, params["B"], X, X))
    rel = abs(measured - predicted) / max(abs(predicted), 1e-9)
    return {"name": f"theorem1/n{spec.n}_k{spec.k}", "measured": measured,
            "predicted": predicted, "rel_err": rel,
            "derived": f"measured={measured:.4f};predicted={predicted:.4f};"
                       f"rel_err={rel:.2e}"}


def autoenc_row(spec: ed.EncDecSpec, params: ed.Params, X: torch.Tensor, *,
                data: str, generator: Optional[torch.Generator],
                steps: int = 400) -> Dict:
    """PCA, FJLT+PCA (FJLT drawn from ``generator``), the closed-form
    butterfly and ``steps`` of Adam at lr 3e-3 on all three matrices."""
    pca = float(ed.pca_loss(X, X, spec.k))
    fjlt = float(ed.fjlt_pca_loss(generator, X, spec.k, spec.ell))
    D, E = ed.optimal_DE(spec, params["B"], X, X)
    closed = float(ed.loss_fn(spec, dict(params, D=D, E=E), X, X))
    trained, _ = ed.train(spec, params, X, X, steps=steps, lr=3e-3)
    gd = float(ed.loss_fn(spec, trained, X, X))
    return {"name": f"autoenc/{data}_k{spec.k}", "pca": pca,
            "fjlt_pca": fjlt, "butterfly_closed": closed,
            "butterfly_gd": gd,
            "derived": f"pca={pca:.4f};fjlt_pca={fjlt:.4f};"
                       f"butterfly_closed={closed:.4f};butterfly_gd={gd:.4f}"}


def two_phase_row(spec: ed.EncDecSpec, params: ed.Params, X: torch.Tensor,
                  *, steps1: int = 400, steps2: int = 300,
                  log_every: int = 0) -> Dict:
    """Phase 1, ``steps1`` of Adam at lr 3e-3 with B frozen, then phase 2,
    ``steps2`` at lr 1e-3 on all three, against the Theorem 1 prediction
    and PCA. ``h1``/``h2`` hold the logged losses (``log_every``)."""
    pred = float(ed.theorem1_loss(spec, params["B"], X, X))
    pca = float(ed.pca_loss(X, X, spec.k))
    p1, h1 = ed.train(spec, params, X, X, steps=steps1, lr=3e-3,
                      train_B=False, log_every=log_every)
    phase1 = float(ed.loss_fn(spec, p1, X, X))
    p2, h2 = ed.train(spec, p1, X, X, steps=steps2, lr=1e-3, train_B=True,
                      log_every=log_every)
    phase2 = float(ed.loss_fn(spec, p2, X, X))
    return {"name": f"two_phase/k{spec.k}", "thm1_prediction": pred,
            "phase1": phase1, "phase2": phase2, "pca": pca, "h1": h1,
            "h2": h2,
            "derived": f"thm1_prediction={pred:.4f};phase1={phase1:.4f};"
                       f"phase2={phase2:.4f};pca={pca:.4f}"}


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _setup(X_np: np.ndarray, k: int, seed: int, dev):
    """Data on ``dev``, a spec from ``seed`` and params from ``seed + 1``:
    the benches' key pattern."""
    X = torch.from_numpy(X_np).to(dev)
    n, d = X.shape
    spec = ed.make_spec(_gen(seed), n=n, d=d, k=k)
    return spec, ed.init_params(_gen(seed + 1), spec, device=dev), X


def bench_rows(dev, steps: int = 400, steps2: int = 300) -> List[Dict]:
    """The three reference benches at their own grids and sizes."""
    rows = []
    for n, k in THEOREM1_SHAPES:
        X_np = np.random.default_rng(n).normal(size=(n, n)).astype(
            np.float32)
        rows.append(theorem1_row(*_setup(X_np, k, n, dev)))
    datasets = (("gaussian1_r32", lambda: gaussian_lowrank(256, 256, 32, 0)),
                ("gaussian2_r64", lambda: gaussian_lowrank(256, 256, 64, 1)),
                ("mnist_like", lambda: synthetic_image_matrix(256, 256, 2)))
    for data, make in datasets:
        X_np = make()
        X = torch.from_numpy(X_np).to(dev)
        for k in AUTOENC_KS:
            # the bench's keys: spec k, FJLT k + 1, params k + 2
            spec = ed.make_spec(_gen(k), n=X.shape[0], d=X.shape[1], k=k)
            params = ed.init_params(_gen(k + 2), spec, device=dev)
            rows.append(autoenc_row(spec, params, X, data=data,
                                    generator=_gen(k + 1), steps=steps))
    X_np = synthetic_image_matrix(256, 256, seed=3)
    for k in TWO_PHASE_KS:
        rows.append(two_phase_row(*_setup(X_np, k, k, dev), steps1=steps,
                                  steps2=steps2))
    return rows


def shape_rows(dev, n: int, d: int, k: int, seed: int = 0, steps: int = 400,
               steps2: int = 300) -> List[Dict]:
    """One row of each kind at ``n x d`` on the MNIST-like stand-in."""
    spec, params, X = _setup(synthetic_image_matrix(n, d, seed), k, seed,
                             dev)
    return [theorem1_row(spec, params, X),
            autoenc_row(spec, params, X, data="mnist_like",
                        generator=_gen(seed + 2), steps=steps),
            two_phase_row(spec, params, X, steps1=steps, steps2=steps2)]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--n", type=int, default=None,
                    help="rows of X (default: the benches' grids)")
    ap.add_argument("--d", type=int, default=None,
                    help="columns of X (default: n)")
    ap.add_argument("--k", type=int, default=8, help="bottleneck")
    ap.add_argument("--steps", type=int, default=400,
                    help="Adam steps of one-phase training and phase 1")
    ap.add_argument("--steps2", type=int, default=300,
                    help="Adam steps of phase 2")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    full_float32()
    if args.n is None:
        rows = bench_rows(dev, args.steps, args.steps2)
    else:
        rows = shape_rows(dev, args.n, args.d or args.n, args.k, args.seed,
                          args.steps, args.steps2)
    for row in rows:
        sys.stdout.write(f"{row['name']},{row['derived']}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

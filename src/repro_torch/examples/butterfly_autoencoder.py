"""Paper §5.2/§5.3: the encoder-decoder butterfly network against PCA and
FJLT+PCA, with two-phase learning and the Theorem 1 prediction.

Run: ``python -m repro_torch.examples.butterfly_autoencoder [--device cpu]``
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import encdec
from repro_torch.kernels.context import resolve_device


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--n", type=int, default=256, help="n = d")
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--steps1", type=int, default=500)
    ap.add_argument("--steps2", type=int, default=300)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = d = args.n
    k = args.k
    rng = np.random.default_rng(0)
    U = np.linalg.qr(rng.normal(size=(n, args.rank)))[0]
    X = torch.from_numpy((U @ rng.normal(scale=0.1, size=(args.rank, d)))
                         .astype(np.float32)).to(dev)

    spec = encdec.make_spec(torch.Generator().manual_seed(0), n=n, d=d, k=k)
    params = encdec.init_params(torch.Generator().manual_seed(1), spec,
                                device=dev)
    print(f"auto-encoder: n={n}, d={d}, k={k}, ell={spec.ell} "
          f"(butterfly encoder params ≈ {spec.ell}·{k} + 2n·log n)")
    pca = float(encdec.pca_loss(X, X, k))
    fjlt = float(encdec.fjlt_pca_loss(torch.Generator().manual_seed(2), X, k,
                                      spec.ell))
    pred = float(encdec.theorem1_loss(spec, params["B"], X, X))
    print(f"PCA Δ_k                 : {pca:.5f}")
    print(f"FJLT+PCA (Prop. 4.1)    : {fjlt:.5f}")
    print(f"Theorem 1 prediction    : {pred:.5f}  (optimal loss, B frozen)")

    # the execution context is per call: context="torch" runs both phases
    # through the plain versions, the default through the kernels on the
    # card
    log = max(min(args.steps1, args.steps2) // 3, 1)
    print("\n-- phase 1: train (D,E), B frozen at FJLT init --")
    p1, hist1 = encdec.train(spec, params, X, X, steps=args.steps1, lr=3e-3,
                             train_B=False, log_every=log)
    print("  losses:", [f"{v:.4f}" for v in hist1])
    print("\n-- phase 2: fine-tune D, E and the butterfly B --")
    p2, hist2 = encdec.train(spec, p1, X, X, steps=args.steps2, lr=1e-3,
                             train_B=True, log_every=log)
    print("  losses:", [f"{v:.4f}" for v in hist2])
    final = float(encdec.loss_fn(spec, p2, X, X))
    print(f"\nfinal loss {final:.5f} vs PCA {pca:.5f} "
          f"(paper §5.2: ≈ Δ_k for all k)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

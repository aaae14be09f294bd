"""Paper §6: learn a butterfly sketch for low-rank decomposition and compare
with learned-sparse (IVY19), random CW and Gaussian sketches.

Run: ``python -m repro_torch.examples.learned_sketch [--device cpu]``
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.kernels.context import resolve_device
from repro_torch.launch.paper import sketch_errors


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--d", type=int, default=48)
    ap.add_argument("--ell", type=int, default=16)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, d, ell, k = args.n, args.d, args.ell, args.k
    rng = np.random.default_rng(0)
    base = rng.normal(size=(n, d)) @ np.diag(np.linspace(1, 0.02, d))
    Xs = np.stack([(base + 0.05 * rng.normal(size=(n, d))).astype(np.float32)
                   for _ in range(32)])
    X = torch.from_numpy(Xs).to(dev)
    train, test = X[:24], X[24:]
    print(f"learning an {ell}x{n} butterfly sketch (k={k}) on "
          f"{len(train)} matrices ...")
    e = sketch_errors(train, test, ell, k, args.steps, dense=False,
                      log_every=max(args.steps // 5, 1))
    print("  train losses:", [f"{v:.3f}" for v in e["history"]])
    print(f"\ntest error (vs exact rank-{k}):")
    print(f"  butterfly learned : {e['butterfly_learned']:.4f}   "
          f"<- this paper")
    print(f"  sparse learned    : {e['sparse_learned']:.4f}   (IVY'19)")
    print(f"  CW random         : {e['cw_random']:.4f}")
    print(f"  Gaussian          : {e['gaussian']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

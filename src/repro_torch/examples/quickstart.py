"""Quickstart: the paper's butterfly sandwich as a drop-in dense replacement.

Run: ``python -m repro_torch.examples.quickstart [--device cpu]``

Shows, through :class:`repro_torch.nn.ButterflyLinear`, (1) the parameter
reduction, (2) Proposition 3.1's approximation at init (``from_dense``),
(3) trainability: the sandwich learns a random linear map through the
sandwich kernels (``SandwichFn``, forward and backward), and (4) the
execution context: a per-call ``context="torch"``, or an ambient ``with
use_execution("torch"):`` block, runs the same layer through the plain
PyTorch version.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import nn
from repro_torch.kernels.context import resolve_device, use_execution
from repro_torch.optim import optimizer as opt


LR = 3e-3


def fit(layer: nn.ButterflyLinear, X: torch.Tensor, Y: torch.Tensor,
        steps: int) -> Tuple[List[float], List[float]]:
    """``steps`` of Adam (no decay, ``LR``) on ``mean((layer(X) - Y)²)``
    over the layer's weights, in place. Returns the loss before each step
    and each step's seconds (ending in a wait for the device)."""
    times: List[float] = []
    losses = opt.fit(lambda: torch.mean(torch.square(layer(X) - Y)),
                     layer.params(), steps, LR, log_every=1,
                     step_times=times)
    return losses, times


def init_error(layer: nn.ButterflyLinear, W: torch.Tensor,
               x: torch.Tensor) -> float:
    """Proposition 3.1's error at init, ``||layer(x) − W x|| / ||W||₂``,
    for a unit vector ``x``."""
    with torch.no_grad():
        approx = layer(x[None])[0]
        return float(torch.linalg.norm(approx - W @ x)
                     / torch.linalg.matrix_norm(W, ord=2))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--k", type=int, default=64, help="k_in = k_out")
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n
    print(f"== Butterfly sandwich replacing a dense {n}x{n} layer ==")

    # --- Proposition 3.1: approximate a given W at init ---
    W = np.random.default_rng(0).normal(size=(n, n)).astype(np.float32)
    W /= np.sqrt(n)
    layer = nn.ButterflyLinear.from_dense(
        torch.Generator().manual_seed(0), W, k_in=args.k, k_out=args.k,
        device=dev)
    print(f"dense params:     {layer.dense_param_count():,}")
    print(f"butterfly params: {layer.param_count():,} "
          f"(k_in={layer.spec.k_in}, k_out={layer.spec.k_out})")
    x = np.random.default_rng(1).normal(size=(n,)).astype(np.float32)
    x /= np.linalg.norm(x)
    Wt, xt = torch.from_numpy(W).to(dev), torch.from_numpy(x).to(dev)
    print(f"init approximation error (k={args.k}): "
          f"{init_error(layer, Wt, xt):.3f} · ||W||")

    # --- train to recover the map ---
    X = torch.randn(args.rows, n, generator=torch.Generator().manual_seed(
        2)).to(dev)
    losses, _ = fit(layer, X, X @ Wt.T, args.steps)
    with torch.no_grad():
        final = float(torch.mean(torch.square(layer(X) - X @ Wt.T)))
    print(f"loss before training: {losses[0]:.5f}" if losses else
          "loss before training: (no steps)")
    print(f"loss after {args.steps} steps: {final:.5f}")

    # --- the execution context: per call, or ambient for a block ---
    with torch.no_grad():
        plain = layer(xt[None], context="torch")
        with use_execution("torch"):
            ambient = layer(xt[None])
        same = (torch.allclose(plain, layer(xt[None]), atol=2e-4, rtol=2e-4)
                and torch.equal(plain, ambient))
    print(f"context='torch' (the plain version) matches the default "
          f"route: {bool(same)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

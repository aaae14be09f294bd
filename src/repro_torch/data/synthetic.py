"""Data matrices of the paper's §5.2 and §6 experiments, made with numpy
from a seed: copies of the reference benchmarks' generators
(``benchmarks/common.py``, ``benchmarks/bench_sketch.py``) that return the
same float32 arrays bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def gaussian_lowrank(n: int, d: int, rank: int, seed: int = 0,
                     scale: float = 0.1) -> np.ndarray:
    """The paper's 'Gaussian 1/2' matrices: ``(n, d)`` with a random
    rank-``rank`` column space."""
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.normal(size=(n, rank)))[0]
    C = rng.normal(scale=scale, size=(rank, d))
    return (U @ C).astype(np.float32)


def synthetic_image_matrix(n: int, d: int, seed: int = 0) -> np.ndarray:
    """MNIST-like stand-in, ``(n, d)``: ``d`` smooth low-frequency images of
    ``sqrt(n)`` x ``sqrt(n)`` pixels plus noise, one per column, the pixel
    coordinates randomly permuted as in the paper (§5.2)."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n))
    xx, yy = np.meshgrid(np.linspace(0, 1, side), np.linspace(0, 1, side))
    imgs = []
    for _ in range(d):
        fx = rng.integers(1, 5, size=2)
        phase = rng.uniform(0, 2 * np.pi, size=2)
        img = (np.sin(2 * np.pi * fx[0] * xx + phase[0])
               * np.cos(2 * np.pi * fx[1] * yy + phase[1]))
        img += 0.1 * rng.normal(size=img.shape)
        imgs.append(img.reshape(-1)[:n])
    M = np.stack(imgs, axis=1)
    perm = rng.permutation(n)
    return M[perm].astype(np.float32)


def sketch_datasets(n: int = 64, d: int = 48, t_train: int = 24,
                    t_test: int = 8
                    ) -> Tuple[Dict[str, List[np.ndarray]], int]:
    """The §6 sketch benches' matrices, ``t_train + t_test`` of ``(n, d)``
    each: ``hyper_like`` (HS-SOD-like: a smooth decaying spectrum plus
    noise) and ``cifar_like`` (rank 8 plus noise), from one
    ``default_rng(0)`` in that order. Returns ``(datasets, t_train)``."""
    rng = np.random.default_rng(0)
    t = t_train + t_test
    base = rng.normal(size=(n, d)) @ np.diag(np.linspace(1, 0.02, d))
    hyper = [(base + 0.05 * rng.normal(size=(n, d))).astype(np.float32)
             for _ in range(t)]
    base2 = rng.normal(size=(n, 8)) @ rng.normal(size=(8, d))
    cifar = [(base2 + 0.2 * rng.normal(size=(n, d))).astype(np.float32)
             for _ in range(t)]
    return {"hyper_like": hyper, "cifar_like": cifar}, t_train

"""Data matrices of the paper's §5.2 experiments, made with numpy from a
seed: copies of the reference benchmarks' generators
(``benchmarks/common.py``) that return the same float32 arrays bit for bit.
"""

from __future__ import annotations

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

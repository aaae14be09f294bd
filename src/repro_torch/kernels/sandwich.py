"""Fused butterfly-sandwich forward: CUDA kernel, plain twin, wrapper.

Counterpart of ``repro.kernels.sandwich`` (forward only; the backward
kernel comes with training). Computes, per row of ``x``,

    butterfly(b_in) → select idx_in → core (k2 × k1) → scatter idx_out
    → transposed butterfly(b_out)

with the reference kernel's precision points: the input stages in ``x``'s
dtype, select/core/scatter in float32, the scattered row cast to ``x``'s
dtype before the output stages. Both versions here keep each stage chain in
float32 over weights rounded to ``x``'s dtype and round once at its end.
The two differ only in float32 rounding order (fused multiply-adds, the
core's summation order), which the reference's tolerances cover.

Selection and scatter take int32 index arrays: the reference's one-hot
matmuls were a TPU workaround. The wrapper also folds the sandwich layer's
padding (``n_in`` → ``n1``) and slicing (``n2`` → ``n_out``) into the
kernel's loads and stores.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core import butterfly as bf
from repro_torch.kernels import build
from repro_torch.kernels.context import resolve_backend

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def sandwich_plain(x: torch.Tensor, b_in: torch.Tensor, core: torch.Tensor,
                   b_out: torch.Tensor, idx_in: torch.Tensor,
                   idx_out: torch.Tensor, *, scale_in: float,
                   scale_out: float, n_out: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, same precision points.

    ``x`` (..., n_in) with ``n_in <= n1``; ``b_in`` (p1, 2, n1); ``core``
    (k2, k1); ``b_out`` (p2, 2, n2); ``idx_in`` (k1,), ``idx_out`` (k2,)
    int. Returns (..., n_out) in ``x``'s dtype.
    """
    dt = x.dtype
    n1 = b_in.shape[-1]
    n2 = b_out.shape[-1]
    h = F.pad(x.float(), (0, n1 - x.shape[-1]))
    h = bf.butterfly_apply(b_in.to(dt).float(), h)
    h1 = h.to(dt).float()[..., idx_in.long()] * scale_in
    h2 = h1 @ core.float().T
    z = h2.new_zeros(h2.shape[:-1] + (n2,))
    z[..., idx_out.long()] = h2 * scale_out
    z = bf.butterfly_transpose_apply(b_out.to(dt).float(), z.to(dt).float())
    return z[..., :n_out].to(dt)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("sandwich")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sandwich_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                 f, f, i, p]
    lib.sandwich_fwd.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _sandwich_cuda(x, b_in, core, b_out, idx_in, idx_out, scale_in,
                   scale_out, n_out):
    if x.dtype not in _DTYPES:
        raise TypeError(f"sandwich kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    dev = x.device
    _check("x", x, x.dtype, dev)
    for name, w in (("b_in", b_in), ("core", core), ("b_out", b_out)):
        _check(name, w, torch.float32, dev)
    for name, w in (("idx_in", idx_in), ("idx_out", idx_out)):
        _check(name, w, torch.int32, dev)
    p1, two1, n1 = b_in.shape
    p2, two2, n2 = b_out.shape
    k2, k1 = core.shape
    n_in = x.shape[-1]
    if (two1, two2) != (2, 2) or 2**p1 != n1 or 2**p2 != n2:
        raise ValueError(f"bad stage weights {tuple(b_in.shape)}, "
                         f"{tuple(b_out.shape)}")
    if idx_in.shape != (k1,) or idx_out.shape != (k2,):
        raise ValueError(f"index shapes {tuple(idx_in.shape)}, "
                         f"{tuple(idx_out.shape)} do not match core "
                         f"{tuple(core.shape)}")
    if not (n_in <= n1 and n_out <= n2):
        raise ValueError(f"n_in {n_in} > n1 {n1} or n_out {n_out} > n2 {n2}")
    rows = x.numel() // n_in
    out = torch.empty(x.shape[:-1] + (n_out,), dtype=x.dtype, device=dev)
    if rows == 0:
        return out
    err = _lib().sandwich_fwd(
        x.data_ptr(), b_in.data_ptr(), core.data_ptr(), b_out.data_ptr(),
        idx_in.data_ptr(), idx_out.data_ptr(), out.data_ptr(), rows, n_in,
        n1, k1, k2, n2, n_out, float(scale_in), float(scale_out),
        _DTYPES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sandwich_fwd launch failed with cudaError {err} "
                           f"(rows={rows}, n1={n1}, n2={n2}, k1={k1}, "
                           f"k2={k2})")
    sandwich_forward.launches += 1
    return out


def sandwich_forward(x: torch.Tensor, b_in: torch.Tensor, core: torch.Tensor,
                     b_out: torch.Tensor, idx_in: torch.Tensor,
                     idx_out: torch.Tensor, *, scale_in: float,
                     scale_out: float, n_out: int,
                     backend: str = "auto") -> torch.Tensor:
    """The sandwich over the last axis: (..., n_in) -> (..., n_out).

    ``backend`` follows :mod:`repro_torch.kernels.context`. The CUDA route
    takes float32 or bfloat16 ``x`` and float32 weights, all contiguous on
    ``x``'s device, and counts each launch in ``sandwich_forward.launches``.
    """
    if resolve_backend(backend, x) == "torch":
        return sandwich_plain(x, b_in, core, b_out, idx_in, idx_out,
                              scale_in=scale_in, scale_out=scale_out,
                              n_out=n_out)
    return _sandwich_cuda(x, b_in, core, b_out, idx_in, idx_out, scale_in,
                          scale_out, n_out)


sandwich_forward.launches = 0

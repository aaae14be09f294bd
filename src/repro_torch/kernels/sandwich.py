"""Fused butterfly sandwich, forward and backward: CUDA kernels, plain
twins, and the autograd Function that joins them.

Counterpart of ``repro.kernels.sandwich``. The forward computes, per row of
``x``,

    butterfly(b_in) → select idx_in → core (k2 × k1) → scatter idx_out
    → transposed butterfly(b_out)

with the reference kernel's precision points: the input stages in ``x``'s
dtype, select/core/scatter in float32, the scattered row cast to ``x``'s
dtype before the output stages. Both versions here keep each stage chain in
float32 over weights rounded to ``x``'s dtype and round once at its end.
The two differ only in float32 rounding order (fused multiply-adds, the
core's summation order), which the reference's tolerances cover.

The backward (the reference's ``_sandwich_bwd_kernel``) recomputes the
forward and takes the VJP through both butterflies and the core, rounding
where the reference casts: ``gz`` and ``du`` to ``x``'s dtype, ``dx`` when
stored; the weight gradients are float32, taken w.r.t. the weights rounded
to ``x``'s dtype. :class:`SandwichFn` runs the forward kernel and the
backward kernel on a CUDA tensor, and both plain twins on a CPU tensor.

Selection and scatter take int32 index arrays: the reference's one-hot
matmuls were a TPU workaround. The wrappers also fold the sandwich layer's
padding (``n_in`` → ``n1``) and slicing (``n2`` → ``n_out``) into the
kernels' loads and stores.
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


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("sandwich_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sandwich_bwd_workspace.argtypes = [i, i, i, i, i, i, i, p]
    lib.sandwich_bwd_workspace.restype = ctypes.c_int
    lib.sandwich_bwd.argtypes = [p] * 14 + [i] * 9 + [f, f, i, p]
    lib.sandwich_bwd.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_args(x, b_in, core, b_out, idx_in, idx_out, n_out):
    """Validate the kernels' common arguments; returns (n1, k1, k2, n2)."""
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
    return n1, k1, k2, n2


def _sandwich_cuda(x, b_in, core, b_out, idx_in, idx_out, scale_in,
                   scale_out, n_out):
    n1, k1, k2, n2 = _check_args(x, b_in, core, b_out, idx_in, idx_out,
                                 n_out)
    n_in = x.shape[-1]
    rows = x.numel() // n_in
    out = torch.empty(x.shape[:-1] + (n_out,), dtype=x.dtype,
                      device=x.device)
    if rows == 0:
        return out
    err = _lib().sandwich_fwd(
        x.data_ptr(), b_in.data_ptr(), core.data_ptr(), b_out.data_ptr(),
        idx_in.data_ptr(), idx_out.data_ptr(), out.data_ptr(), rows, n_in,
        n1, k1, k2, n2, n_out, float(scale_in), float(scale_out),
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sandwich_fwd launch failed with cudaError {err} "
                           f"(rows={rows}, n1={n1}, n2={n2}, k1={k1}, "
                           f"k2={k2})")
    sandwich_forward.launches += 1
    return out


def sandwich_bwd_plain(x: torch.Tensor, b_in: torch.Tensor,
                       core: torch.Tensor, b_out: torch.Tensor,
                       idx_in: torch.Tensor, idx_out: torch.Tensor,
                       g: torch.Tensor, *, scale_in: float,
                       scale_out: float, n_out: int):
    """Plain twin of the backward kernel: the VJP of :func:`sandwich_plain`
    at ``x`` for the output cotangent ``g`` (..., n_out), by autograd over
    the same forward with the weights rounded to ``x``'s dtype as leaves.

    Returns ``(dx, d b_in, d core, d b_out)``: ``dx`` in ``x``'s dtype and
    shape, the weight gradients float32. Autograd's casts give the
    reference's rounding points: the cotangent of the scattered row (``gz``)
    and of the selected row (``du``) are rounded to ``x``'s dtype.
    """
    dt = x.dtype
    n1, n2 = b_in.shape[-1], b_out.shape[-1]
    with torch.enable_grad():
        xf = x.detach().float().requires_grad_()
        w_in = b_in.detach().to(dt).float().requires_grad_()
        w_core = core.detach().float().requires_grad_()
        w_out = b_out.detach().to(dt).float().requires_grad_()
        h = F.pad(xf, (0, n1 - x.shape[-1]))
        h = bf.butterfly_apply(w_in, h)
        h1 = h.to(dt).float()[..., idx_in.long()] * scale_in
        h2 = h1 @ w_core.T
        z = h2.new_zeros(h2.shape[:-1] + (n2,))
        z[..., idx_out.long()] = h2 * scale_out
        z = bf.butterfly_transpose_apply(w_out, z.to(dt).float())
        dx, d_in, d_core, d_out = torch.autograd.grad(
            z[..., :n_out], (xf, w_in, w_core, w_out),
            grad_outputs=g.to(dt).float())
    return dx.to(dt), d_in, d_core, d_out


BWD_KERNELS = 3           # output side, input side, reduction


def _bwd_chunks(rows: int, tiles: int, device) -> tuple:
    """Row chunks of the backward's output-side and input-side launches:
    about two blocks per SM, each chunk at least one row."""
    blocks = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    return (min(rows, max(1, blocks // tiles)), min(rows, blocks))


def _sandwich_bwd_cuda(x, b_in, core, b_out, idx_in, idx_out, g, scale_in,
                       scale_out, n_out):
    n1, k1, k2, n2 = _check_args(x, b_in, core, b_out, idx_in, idx_out,
                                 n_out)
    _check("g", g, x.dtype, x.device)
    n_in = x.shape[-1]
    rows = x.numel() // n_in
    if g.shape != x.shape[:-1] + (n_out,):
        raise ValueError(f"g shape {tuple(g.shape)} does not match x "
                         f"{tuple(x.shape)} and n_out {n_out}")
    dev = x.device
    dx = torch.empty_like(x)
    d_in = torch.empty(b_in.shape, dtype=torch.float32, device=dev)
    d_core = torch.empty(core.shape, dtype=torch.float32, device=dev)
    d_out = torch.empty(b_out.shape, dtype=torch.float32, device=dev)
    if rows == 0:
        return dx, d_in.zero_(), d_core.zero_(), d_out.zero_()
    lib = _bwd_lib()
    tiles = n2 // min(n2, 4096)
    chunks_a, chunks_b = _bwd_chunks(rows, tiles, dev)
    sizes = (ctypes.c_longlong * 3)()
    err = lib.sandwich_bwd_workspace(rows, n1, k1, k2, n2, chunks_a,
                                     chunks_b, sizes)
    if err != 0:
        raise ValueError(f"sandwich_bwd takes no n1={n1}, n2={n2}, k1={k1}, "
                         f"k2={k2}")
    gsel, pa, pb = (torch.empty(int(n), dtype=torch.float32, device=dev)
                    for n in sizes)
    err = lib.sandwich_bwd(
        x.data_ptr(), b_in.data_ptr(), core.data_ptr(), b_out.data_ptr(),
        idx_in.data_ptr(), idx_out.data_ptr(), g.data_ptr(), dx.data_ptr(),
        d_in.data_ptr(), d_core.data_ptr(), d_out.data_ptr(),
        gsel.data_ptr(), pa.data_ptr(), pb.data_ptr(), rows, n_in, n1, k1,
        k2, n2, n_out, chunks_a, chunks_b, float(scale_in),
        float(scale_out), _DTYPES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sandwich_bwd launch failed with cudaError {err} "
                           f"(rows={rows}, n1={n1}, n2={n2}, k1={k1}, "
                           f"k2={k2})")
    sandwich_backward.launches += BWD_KERNELS
    return dx, d_in, d_core, d_out


def sandwich_backward(x: torch.Tensor, b_in: torch.Tensor,
                      core: torch.Tensor, b_out: torch.Tensor,
                      idx_in: torch.Tensor, idx_out: torch.Tensor,
                      g: torch.Tensor, *, scale_in: float, scale_out: float,
                      n_out: int, backend: str = "auto"):
    """The sandwich's VJP: ``(dx, d b_in, d core, d b_out)`` for the output
    cotangent ``g`` (..., n_out). ``backend`` follows
    :mod:`repro_torch.kernels.context`; the CUDA route adds its three kernel
    launches (output side, input side, reduction) to
    ``sandwich_backward.launches``."""
    if resolve_backend(backend, x) == "torch":
        return sandwich_bwd_plain(x, b_in, core, b_out, idx_in, idx_out, g,
                                  scale_in=scale_in, scale_out=scale_out,
                                  n_out=n_out)
    return _sandwich_bwd_cuda(x, b_in, core, b_out, idx_in, idx_out, g,
                              scale_in, scale_out, n_out)


sandwich_backward.launches = 0


class SandwichFn(torch.autograd.Function):
    """The sandwich as one differentiable op: the forward kernel forward,
    the backward kernel backward (``route="cuda"``), or both plain twins
    (``route="torch"``). The index tensors and scales get no gradient; the
    weight gradients come back in the weights' dtypes."""

    @staticmethod
    def forward(ctx, x, b_in, core, b_out, idx_in, idx_out, scale_in,
                scale_out, n_out, route):
        ctx.save_for_backward(x, b_in, core, b_out, idx_in, idx_out)
        ctx.meta = dict(scale_in=scale_in, scale_out=scale_out, n_out=n_out)
        ctx.route = route
        if route == "torch":
            return sandwich_plain(x, b_in, core, b_out, idx_in, idx_out,
                                  **ctx.meta)
        return _sandwich_cuda(x, b_in, core, b_out, idx_in, idx_out,
                              scale_in, scale_out, n_out)

    @staticmethod
    def backward(ctx, g):
        x, b_in, core, b_out, idx_in, idx_out = ctx.saved_tensors
        dx, d_in, d_core, d_out = sandwich_backward(
            x, b_in, core, b_out, idx_in, idx_out,
            g.to(x.dtype).contiguous(), backend=ctx.route, **ctx.meta)
        return (dx, d_in.to(b_in.dtype), d_core.to(core.dtype),
                d_out.to(b_out.dtype), None, None, None, None, None, None)


def sandwich_forward(x: torch.Tensor, b_in: torch.Tensor, core: torch.Tensor,
                     b_out: torch.Tensor, idx_in: torch.Tensor,
                     idx_out: torch.Tensor, *, scale_in: float,
                     scale_out: float, n_out: int,
                     backend: str = "auto") -> torch.Tensor:
    """The sandwich over the last axis: (..., n_in) -> (..., n_out),
    differentiable in ``x``, ``b_in``, ``core`` and ``b_out`` through
    :class:`SandwichFn`.

    ``backend`` follows :mod:`repro_torch.kernels.context`. The CUDA route
    takes float32 or bfloat16 ``x`` and float32 weights, all contiguous on
    ``x``'s device, and counts each forward launch in
    ``sandwich_forward.launches``.
    """
    return SandwichFn.apply(x, b_in, core, b_out, idx_in, idx_out, scale_in,
                            scale_out, n_out, resolve_backend(backend, x))


sandwich_forward.launches = 0

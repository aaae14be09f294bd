"""Fused butterfly sandwich, forward and backward: CUDA kernels, plain
twins, and the autograd Function that joins them.

Counterpart of ``repro.kernels.sandwich``. The forward computes, per row of
``x``,

    butterfly(b_in) → select idx_in → core (k2 × k1) → scatter idx_out
    → transposed butterfly(b_out)

with the reference kernel's precision points: the input stages in ``x``'s
dtype, select/core/scatter in float32, the scattered row cast to ``x``'s
dtype before the output stages. :func:`sandwich_plain`, the forward's
reference twin, keeps each stage chain in float32 over weights rounded to
``x``'s dtype and rounds once at its end.

On the card the forward is two kernels (``FWD_KERNELS``). A truncated
butterfly with k kept outputs is a k × n factor, so the sandwich is
``out = F_outᵀ · core · F_in · x`` with ``F_in = B_in[idx_in, :n_in]`` and
``F_out = B_out[idx_out, :n_out]``, rows of the butterflies (the transposed
butterfly on one-hot rows). The factor kernel builds both from the call's
weights rounded to ``x``'s dtype (:func:`sandwich_factors_plain` is its
twin); the row kernel runs tiles of rows through three products at the
same rounding points, ``h1 = rnd(x · F_inᵀ) · scale_in``,
``z = rnd((h1 · coreᵀ) · scale_out)``, ``out = rnd(z · F_out)``
(:func:`sandwich_rows_plain`). In float32 the row kernel takes all three
as products and sums in another order than the stage chain, which the
reference's tolerances cover. In bfloat16 ``h1`` is a rounding point that
every output of the row hangs on, so there the row kernel computes it by
the input butterfly itself, operation for operation as
:func:`sandwich_plain` does (same bits); ``z`` and the output round as
above and differ from the twin at most by a bfloat16 step at a tie.

The backward (the reference's ``_sandwich_bwd_kernel``) takes the VJP
through the same factors, rounding where the reference casts: per row
``gz = rnd(g · F_outᵀ)`` (the output butterfly's VJP at ``idx_out``),
``dh2 = gz · scale_out``, ``du = rnd((dh2 · core) · scale_in)`` and ``dx =
rnd(du · F_in)``; summed over rows ``d core = dh2ᵀ h1``, ``dF_in = duᵀ x``
and ``dF_out = zᵀ g``; and the stage-weight gradients are the VJP of the
factor construction (the transposed butterfly on k one-hot rows) at those
cotangents, which by linearity is the stage chains' weight gradient over
all rows, summed in another order. On the card that is six launches
(``BWD_KERNELS``) in one call: the factor kernel again (the backward
rebuilds the factors from the saved weights rather than keeping the
forward's workspace alive across remat), the row kernel, the column kernel,
the sum of its row splits, the factor-row VJP and the reduction. Each has a
plain twin here (:func:`sandwich_factors_plain`,
:func:`sandwich_bwd_rows_plain`, :func:`sandwich_bwd_cols_plain`,
:func:`sandwich_factors_vjp_plain`); their composition is
:func:`sandwich_bwd_plain`, the autograd VJP of :func:`sandwich_plain` and
the oracle of the whole backward. The weight gradients are float32, taken
w.r.t. the weights rounded to ``x``'s dtype. :class:`SandwichFn` runs the
forward and backward kernels on a CUDA tensor, and the plain twins on a CPU
tensor.

The kernels take ``n1 <= MAX_N1``, ``n2 <= MAX_N2`` and ``k1, k2 <= MAX_K``
(the reference's zoo reaches n1 = 32,768 at mistral-large's ``down`` and
n2 = 262,144 at gemma3-27b's head); the wrappers raise ``ValueError`` past
them, before any launch.

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
from repro_torch.obs.profiling import annotate

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


def sandwich_factors_plain(b_in: torch.Tensor, b_out: torch.Tensor,
                           idx_in: torch.Tensor, idx_out: torch.Tensor,
                           n_in: int, n_out: int, dtype: torch.dtype
                           ) -> tuple:
    """Plain twin of the factor kernel: ``F_in = B_in[idx_in, :n_in]`` (k1,
    n_in) and ``F_out = B_out[idx_out, :n_out]`` (k2, n_out), float32, the
    transposed butterfly on one-hot rows over the weights rounded to
    ``dtype``."""
    def rows(w, idx, n):
        return bf.materialize_truncated(w.to(dtype).float(), idx.long(),
                                        jl_scale=False)[:, :n]
    return rows(b_in, idx_in, n_in), rows(b_out, idx_out, n_out)


def sandwich_rows_plain(x: torch.Tensor, f_in: torch.Tensor,
                        core: torch.Tensor, f_out: torch.Tensor, *,
                        scale_in: float, scale_out: float) -> torch.Tensor:
    """Plain twin of the row kernel: (..., n_in) -> (..., n_out) through
    the factors of :func:`sandwich_factors_plain`, rounding to ``x``'s
    dtype where the reference casts (``h1``, ``z``, the output)."""
    dt = x.dtype
    h1 = (x.float() @ f_in.float().T).to(dt).float() * scale_in
    z = ((h1 @ core.float().T) * scale_out).to(dt).float()
    return (z @ f_out.float()).to(dt)


FWD_KERNELS = 2           # factors, rows
BWD_KERNELS = 6           # factors, rows, columns, their sum, factor-row
                          # VJP, reduction
MAX_N1, MAX_N2, MAX_K = 32768, 262144, 64   # the kernels' widths
_PAD_K, _PAD_N = 16, 128  # the factors' rows and columns padded to multiples


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("sandwich")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sandwich_factors.argtypes = [p] * 7 + [i] * 11 + [p]
    lib.sandwich_factors.restype = ctypes.c_int
    lib.sandwich_fwd.argtypes = [p] * 8 + [i] * 12 + [f, f, i, p]
    lib.sandwich_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _groups(rows: int, chunks: int, sms: int) -> int:
    """Column groups of the row kernel (row tiles of 64 rows times groups
    of 128-wide output chunks), about one block per SM where the chunks
    allow. Every group of a row tile runs its input side again: narrow
    outputs (the MLP's), where that side takes most of a block's time, round
    the count down to one group per tile once there are about as many tiles
    as SMs; wide ones (the head's), bound by their stores, round up, which
    puts two blocks on an SM."""
    tiles = -(-rows // 64)
    if chunks >= 64:
        return min(chunks, -(-sms // tiles))
    return min(chunks, max(1, (sms + tiles // 2) // tiles))


def _layout(k1: int, n_in: int, k2: int, n_out: int, dtype) -> tuple:
    """The forward's workspace: F_in (kp1, ld1) and F_out (kp2, ld2)
    float32, zero-padded (kp a multiple of 16, ld of 128), then for
    bfloat16 F_out's (2, kp2, ld2) hi/lo pair, the row kernel's tensor-core
    operand. Returns ``(kp1, ld1, kp2, ld2, bytes)``."""
    kp1, ld1 = _up(k1, _PAD_K), _up(n_in, _PAD_N)
    kp2, ld2 = _up(k2, _PAD_K), _up(n_out, _PAD_N)
    nbytes = 4 * (kp1 * ld1 + kp2 * ld2)
    if dtype == torch.bfloat16:
        nbytes += 4 * kp2 * ld2
    return kp1, ld1, kp2, ld2, nbytes


def _check_widths(n1: int, n2: int, k1: int, k2: int) -> None:
    if not (n1 <= MAX_N1 and n2 <= MAX_N2 and k1 <= MAX_K and k2 <= MAX_K):
        raise ValueError(f"the sandwich kernels take n1 <= {MAX_N1}, n2 <= "
                         f"{MAX_N2} and k1, k2 <= {MAX_K}; got n1={n1}, "
                         f"n2={n2}, k1={k1}, k2={k2}")


def _factors_cuda(b_in, b_out, idx_in, idx_out, n_in, n_out, dtype):
    """Launch the factor kernel alone into a new workspace (:func:`_layout`)
    and return it as tensors ``(f_in, f_out, hl_out)``, ``hl_out`` None for
    float32."""
    k1, n1 = idx_in.numel(), b_in.shape[-1]
    k2, n2 = idx_out.numel(), b_out.shape[-1]
    _check_widths(n1, n2, k1, k2)
    kp1, ld1, kp2, ld2, nbytes = _layout(k1, n_in, k2, n_out, dtype)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=b_in.device)
    a1, a2 = 4 * kp1 * ld1, 4 * kp2 * ld2
    f_in = ws[:a1].view(torch.float32).view(kp1, ld1)
    f_out = ws[a1:a1 + a2].view(torch.float32).view(kp2, ld2)
    hl_out = (ws[a1 + a2:].view(torch.bfloat16).view(2, kp2, ld2)
              if dtype == torch.bfloat16 else None)
    err = _lib().sandwich_factors(
        b_in.data_ptr(), b_out.data_ptr(), idx_in.data_ptr(),
        idx_out.data_ptr(), f_in.data_ptr(), f_out.data_ptr(),
        None if hl_out is None else hl_out.data_ptr(), n1, k1, n_in, kp1,
        ld1, n2, k2, n_out, kp2, ld2, _DTYPES[dtype],
        torch.cuda.current_stream(b_in.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sandwich_factors launch failed with cudaError "
                           f"{err} (n1={n1}, n2={n2}, k1={k1}, k2={k2})")
    sandwich_forward.launches += 1
    return f_in, f_out, hl_out


def sandwich_factors(b_in: torch.Tensor, b_out: torch.Tensor,
                     idx_in: torch.Tensor, idx_out: torch.Tensor, *,
                     n_in: int, n_out: int, dtype: torch.dtype,
                     backend: str = "auto") -> tuple:
    """``(F_in, F_out)`` of the sandwich, float32 (k1, n_in) and (k2,
    n_out). The CUDA route launches the factor kernel (one count in
    ``sandwich_forward.launches``) and returns views into its workspace."""
    if resolve_backend(backend, b_in) == "torch":
        return sandwich_factors_plain(b_in, b_out, idx_in, idx_out, n_in,
                                      n_out, dtype)
    if dtype not in _DTYPES:
        raise TypeError(f"sandwich factors take float32 or bfloat16, got "
                        f"{dtype}")
    for name, t, want in (("b_in", b_in, torch.float32),
                          ("b_out", b_out, torch.float32),
                          ("idx_in", idx_in, torch.int32),
                          ("idx_out", idx_out, torch.int32)):
        _check(name, t, want, b_in.device)
    f_in, f_out, _ = _factors_cuda(b_in, b_out, idx_in, idx_out, n_in,
                                   n_out, dtype)
    return f_in[:idx_in.numel(), :n_in], f_out[:idx_out.numel(), :n_out]


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("sandwich_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sandwich_bwd_floats.argtypes = [i] * 9
    lib.sandwich_bwd_floats.restype = ctypes.c_longlong
    lib.sandwich_bwd.argtypes = [p] * 12 + [i] * 8 + [f, f, i, p]
    lib.sandwich_bwd.restype = ctypes.c_int
    lib.sandwich_factors_vjp_floats.argtypes = [i] * 4
    lib.sandwich_factors_vjp_floats.restype = ctypes.c_longlong
    lib.sandwich_factors_vjp.argtypes = [p] * 9 + [i] * 7 + [p]
    lib.sandwich_factors_vjp.restype = ctypes.c_int
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
    f32, i32 = torch.float32, torch.int32
    if not (b_in.dtype is f32 and core.dtype is f32 and b_out.dtype is f32
            and idx_in.dtype is i32 and idx_out.dtype is i32
            and b_in.device == dev and core.device == dev
            and b_out.device == dev and idx_in.device == dev
            and idx_out.device == dev and x.is_contiguous()
            and b_in.is_contiguous() and core.is_contiguous()
            and b_out.is_contiguous() and idx_in.is_contiguous()
            and idx_out.is_contiguous()):
        # one test on the hot path; this one names the argument at fault
        _check("x", x, x.dtype, dev)
        for name, w in (("b_in", b_in), ("core", core), ("b_out", b_out)):
            _check(name, w, f32, dev)
        for name, w in (("idx_in", idx_in), ("idx_out", idx_out)):
            _check(name, w, i32, dev)
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
    _check_widths(n1, n2, k1, k2)
    return n1, k1, k2, n2


def _sandwich_cuda(x, b_in, core, b_out, idx_in, idx_out, scale_in,
                   scale_out, n_out):
    n1, k1, k2, n2 = _check_args(x, b_in, core, b_out, idx_in, idx_out,
                                 n_out)
    n_in = x.shape[-1]
    rows = x.numel() // n_in
    dev = x.device
    out = torch.empty(x.shape[:-1] + (n_out,), dtype=x.dtype, device=dev)
    if rows == 0:
        return out
    kp1, ld1, kp2, ld2, nbytes = _layout(k1, n_in, k2, n_out, x.dtype)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    index = dev.index
    err = _lib().sandwich_fwd(
        x.data_ptr(), b_in.data_ptr(), core.data_ptr(), b_out.data_ptr(),
        idx_in.data_ptr(), idx_out.data_ptr(), out.data_ptr(),
        ws.data_ptr(), rows, n_in, n1, k1, n2, k2, n_out, kp1, ld1, kp2, ld2,
        _groups(rows, ld2 // _PAD_N, _sm_count(index)), float(scale_in),
        float(scale_out), _DTYPES[x.dtype],
        torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"sandwich_fwd launch failed with cudaError {err} "
                           f"(rows={rows}, n1={n1}, n2={n2}, k1={k1}, "
                           f"k2={k2})")
    sandwich_forward.launches += FWD_KERNELS
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


def sandwich_bwd_rows_plain(x: torch.Tensor, g: torch.Tensor,
                            f_in: torch.Tensor, core: torch.Tensor,
                            f_out: torch.Tensor, *, scale_in: float,
                            scale_out: float) -> tuple:
    """Plain twin of the backward's row kernel, rows (..., n) flattened:
    ``(dx, h1, z, dh2, du)`` with ``h1 = rnd(x · F_inᵀ) · scale_in``, ``z =
    rnd((h1 · coreᵀ) · scale_out)``, ``dh2 = rnd(g · F_outᵀ) · scale_out``,
    ``du = rnd((dh2 · core) · scale_in)`` (float32 of ``x``'s dtype's
    values, ``rnd`` the rounding to it) and ``dx = rnd(du · F_in)`` in
    ``x``'s dtype and shape."""
    dt = x.dtype
    xf = x.reshape(-1, x.shape[-1]).float()
    gf = g.reshape(-1, g.shape[-1]).float()
    c = core.float()
    h1 = (xf @ f_in.float().T).to(dt).float() * scale_in
    z = ((h1 @ c.T) * scale_out).to(dt).float()
    dh2 = (gf @ f_out.float().T).to(dt).float() * scale_out
    du = ((dh2 @ c) * scale_in).to(dt).float()
    dx = (du @ f_in.float()).to(dt).reshape(x.shape)
    return dx, h1, z, dh2, du


def sandwich_bwd_cols_plain(x: torch.Tensor, g: torch.Tensor,
                            h1: torch.Tensor, z: torch.Tensor,
                            dh2: torch.Tensor, du: torch.Tensor) -> tuple:
    """Plain twin of the backward's column kernel and its ``d core``: the
    sums over rows ``(dF_in, d core, dF_out) = (duᵀ x, dh2ᵀ h1, zᵀ g)``,
    float32 (k1, n_in), (k2, k1), (k2, n_out)."""
    xf = x.reshape(-1, x.shape[-1]).float()
    gf = g.reshape(-1, g.shape[-1]).float()
    return du.T @ xf, dh2.T @ h1, z.T @ gf


def sandwich_factors_vjp_plain(b_in: torch.Tensor, b_out: torch.Tensor,
                               idx_in: torch.Tensor, idx_out: torch.Tensor,
                               d_f_in: torch.Tensor, d_f_out: torch.Tensor,
                               dtype: torch.dtype) -> tuple:
    """Plain twin of the factor-row VJP: ``(d b_in, d b_out)`` float32, the
    VJP of :func:`sandwich_factors_plain` (F_in (k1, n_in), F_out (k2,
    n_out)) at the cotangents ``d_f_in``, ``d_f_out``, by autograd, w.r.t.
    the weights rounded to ``dtype``."""
    with torch.enable_grad():
        w_in = b_in.detach().to(dtype).float().requires_grad_()
        w_out = b_out.detach().to(dtype).float().requires_grad_()
        f_in, f_out = sandwich_factors_plain(
            w_in, w_out, idx_in, idx_out, d_f_in.shape[-1],
            d_f_out.shape[-1], torch.float32)
        return torch.autograd.grad((f_in, f_out), (w_in, w_out),
                                   (d_f_in.float(), d_f_out.float()))


@functools.lru_cache(maxsize=None)
def _bwd_floats(*dims) -> int:
    """The floats of the backward's workspace for ``dims`` (rows, n_in,
    n1, k1, n_out, n2, k2, sms, dtype)."""
    floats = int(_bwd_lib().sandwich_bwd_floats(*dims))
    if floats == 0:
        raise ValueError(f"sandwich_bwd takes no rows, n_in, n1, k1, n_out, "
                         f"n2, k2, sms, dtype = {dims}")
    return floats


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
    # the three weight gradients in one allocation
    sizes = (b_in.numel(), core.numel(), b_out.numel())
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    d_in, d_core, d_out = (t.view(w.shape) for t, w in zip(
        grads.split(sizes), (b_in, core, b_out)))
    if rows == 0:
        grads.zero_()
        return dx, d_in, d_core, d_out
    sms = _sm_count(dev.index)
    ws = torch.empty(_bwd_floats(rows, n_in, n1, k1, n_out, n2, k2, sms,
                                 _DTYPES[x.dtype]),
                     dtype=torch.float32, device=dev)
    err = _bwd_lib().sandwich_bwd(
        x.data_ptr(), g.data_ptr(), core.data_ptr(), b_in.data_ptr(),
        b_out.data_ptr(), idx_in.data_ptr(), idx_out.data_ptr(),
        dx.data_ptr(), d_in.data_ptr(), d_core.data_ptr(), d_out.data_ptr(),
        ws.data_ptr(), rows, n_in, n1, k1, n_out, n2, k2, sms,
        float(scale_in), float(scale_out), _DTYPES[x.dtype],
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"sandwich_bwd launch failed with cudaError {err} "
                           f"(rows={rows}, n1={n1}, n2={n2}, k1={k1}, "
                           f"k2={k2})")
    sandwich_backward.launches += BWD_KERNELS
    return dx, d_in, d_core, d_out


def sandwich_factors_vjp(b_in: torch.Tensor, b_out: torch.Tensor,
                         idx_in: torch.Tensor, idx_out: torch.Tensor,
                         d_f_in: torch.Tensor, d_f_out: torch.Tensor, *,
                         dtype: torch.dtype, backend: str = "auto") -> tuple:
    """``(d b_in, d b_out)``: the VJP of :func:`sandwich_factors` at the
    cotangents ``d_f_in`` (k1, n_in) and ``d_f_out`` (k2, n_out), float32.
    The CUDA route launches the backward's factor-row VJP and reduction
    alone (two counts in ``sandwich_backward.launches``)."""
    if resolve_backend(backend, b_in) == "torch":
        return sandwich_factors_vjp_plain(b_in, b_out, idx_in, idx_out,
                                          d_f_in, d_f_out, dtype)
    if dtype not in _DTYPES:
        raise TypeError(f"sandwich factors take float32 or bfloat16, got "
                        f"{dtype}")
    for name, t, want in (("b_in", b_in, torch.float32),
                          ("b_out", b_out, torch.float32),
                          ("idx_in", idx_in, torch.int32),
                          ("idx_out", idx_out, torch.int32),
                          ("d_f_in", d_f_in, torch.float32),
                          ("d_f_out", d_f_out, torch.float32)):
        _check(name, t, want, b_in.device)
    n1, n2 = b_in.shape[-1], b_out.shape[-1]
    k1, k2 = idx_in.numel(), idx_out.numel()
    _check_widths(n1, n2, k1, k2)
    (_, n_in), (_, n_out) = d_f_in.shape, d_f_out.shape
    if d_f_in.shape != (k1, n_in) or d_f_out.shape != (k2, n_out) or not (
            n_in <= n1 and n_out <= n2):
        raise ValueError(f"cotangents {tuple(d_f_in.shape)}, "
                         f"{tuple(d_f_out.shape)} do not fit k1={k1}, "
                         f"k2={k2}, n1={n1}, n2={n2}")
    lib = _bwd_lib()
    dev = b_in.device
    ws = torch.empty(int(lib.sandwich_factors_vjp_floats(n1, k1, n2, k2)),
                     dtype=torch.float32, device=dev)
    d_in = torch.empty(b_in.shape, dtype=torch.float32, device=dev)
    d_out = torch.empty(b_out.shape, dtype=torch.float32, device=dev)
    err = lib.sandwich_factors_vjp(
        b_in.data_ptr(), b_out.data_ptr(), idx_in.data_ptr(),
        idx_out.data_ptr(), d_f_in.data_ptr(), d_f_out.data_ptr(),
        d_in.data_ptr(), d_out.data_ptr(), ws.data_ptr(), n_in, n1, k1,
        n_out, n2, k2, _DTYPES[dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sandwich_factors_vjp launch failed with "
                           f"cudaError {err} (n1={n1}, n2={n2}, k1={k1}, "
                           f"k2={k2})")
    sandwich_backward.launches += 2
    return d_in, d_out


def sandwich_backward(x: torch.Tensor, b_in: torch.Tensor,
                      core: torch.Tensor, b_out: torch.Tensor,
                      idx_in: torch.Tensor, idx_out: torch.Tensor,
                      g: torch.Tensor, *, scale_in: float, scale_out: float,
                      n_out: int, backend: str = "auto"):
    """The sandwich's VJP: ``(dx, d b_in, d core, d b_out)`` for the output
    cotangent ``g`` (..., n_out). ``backend`` follows
    :mod:`repro_torch.kernels.context`; the CUDA route adds its
    ``BWD_KERNELS`` launches (factors, rows, columns, their sum, factor-row
    VJP, reduction) to ``sandwich_backward.launches``."""
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
    ``x``'s device, launches the factor and the row kernel and counts both
    launches in ``sandwich_forward.launches``.
    """
    route = resolve_backend(backend, x)
    with annotate("sandwich_matmul"):
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in (x, b_in, core, b_out))):
            # nothing to differentiate (serving, no_grad): skip autograd's
            # bookkeeping, the host's share of a decode tick
            if route == "torch":
                return sandwich_plain(x, b_in, core, b_out, idx_in, idx_out,
                                      scale_in=scale_in, scale_out=scale_out,
                                      n_out=n_out)
            return _sandwich_cuda(x, b_in, core, b_out, idx_in, idx_out,
                                  scale_in, scale_out, n_out)
        return SandwichFn.apply(x, b_in, core, b_out, idx_in, idx_out,
                                scale_in, scale_out, n_out, route)


sandwich_forward.launches = 0

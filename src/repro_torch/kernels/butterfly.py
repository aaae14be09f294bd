"""Fused butterfly product, forward and backward: CUDA kernels, plain twins,
and the autograd Function that joins them.

Counterpart of ``repro.kernels.butterfly`` and of the butterfly half of
``repro.kernels.ops``. ``y = B x`` (or ``Bᵀ x``) over the last axis of
``x`` (..., n), ``w`` (p, 2, n) the stage weights, stage ``s`` being
``a_s ⊙ x + b_s ⊙ swap_s(x)`` (``a_s ⊙ x + swap_s(b_s ⊙ x)`` transposed,
stages in reverse order).

Precision points, the same in the kernels and the plain twins: each stage
chain runs in float32 over weights rounded to ``x``'s dtype and is rounded
to ``x``'s dtype once at its end (the reference rounds after every stage;
the port's sandwich kernels made the same choice). The backward's ``dw`` is
float32, taken w.r.t. the rounded weights, and comes back from
:class:`ButterflyFn` in the weights' dtype.

The backward kernel takes the reference's schedule, segmented stage
checkpointing with ``segment = ⌈√p⌉``; :func:`stage_applies` counts its
stage applications per row, the counterpart of the reference's
``count_stage_applies``. It sums ``dw`` in a fixed order: each thread over
its rows in row order, each block over its row slots (:func:`row_slots`),
then over blocks in block order; :func:`butterfly_bwd_tiled_plain` is the
plain twin of that order, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.core import butterfly as bf
from repro_torch.kernels import build
from repro_torch.kernels.context import resolve_backend
from repro_torch.obs.profiling import annotate

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 32768             # one float32 row in shared memory (128 KB)
BWD_KERNELS = 2           # the row-tile VJP, the reduction of dw over blocks
BWD_THREADS = 512         # backward kernel: threads a block, 2 elements each


def default_segment(stages: int) -> int:
    """⌈√p⌉, the reference's default checkpoint interval."""
    if stages <= 1:
        return 1
    return math.isqrt(stages - 1) + 1


def stage_applies(p: int, segment: Optional[int] = None) -> int:
    """Stage applications per row of the segmented backward of a ``p``-stage
    chain: the checkpoint sweep up to the last checkpoint, the recompute
    inside each segment, and the ``p`` dual stages. ``segment`` defaults to
    ⌈√p⌉ and is clamped to ``[1, p]``."""
    seg = max(1, min(segment or default_segment(p), max(p, 1)))
    bounds = list(range(0, p, seg))
    if not bounds:
        return 0
    return (bounds[-1] + sum(min(j0 + seg, p) - j0 - 1 for j0 in bounds)
            + p)


def butterfly_plain(x: torch.Tensor, w: torch.Tensor, *,
                    transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel, same precision points."""
    dt = x.dtype
    fn = bf.butterfly_transpose_apply if transpose else bf.butterfly_apply
    return fn(w.to(dt).float(), x.float()).to(dt)


def butterfly_bwd_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                        *, transpose: bool = False, need_dx: bool = True):
    """Plain twin of the backward kernel: the VJP of :func:`butterfly_plain`
    at ``x`` for the cotangent ``g``, by autograd over the float32 chain
    with the weights rounded to ``x``'s dtype as leaves. Returns
    ``(dx, dw)``: ``dx`` in ``x``'s dtype (``None`` unless ``need_dx``),
    ``dw`` float32."""
    dt = x.dtype
    fn = bf.butterfly_transpose_apply if transpose else bf.butterfly_apply
    with torch.enable_grad():
        xf = x.detach().float().requires_grad_(need_dx)
        wf = w.detach().to(dt).float().requires_grad_()
        y = fn(wf, xf)
        leaves = (xf, wf) if need_dx else (wf,)
        grads = torch.autograd.grad(y, leaves, grad_outputs=g.to(dt).float())
    if need_dx:
        return grads[0].to(dt), grads[1]
    return None, grads[0]


def row_slots(n: int) -> int:
    """Rows the backward kernel's block works side by side, each slot with
    its own ``dw`` sums: ``BWD_THREADS`` threads of 2 elements a row."""
    return max(1, 2 * BWD_THREADS // n)


def butterfly_bwd_tiled_plain(x: torch.Tensor, w: torch.Tensor,
                              g: torch.Tensor, *, transpose: bool = False,
                              need_dx: bool = True, blocks: int = 1):
    """Plain twin of the backward kernel's operations and summation order:
    the same ``(dx, dw)`` as :func:`butterfly_bwd_plain`, with ``dw``
    summed as the kernel sums it over ``blocks`` blocks. Each row's terms
    are ``g ⊙ x_s`` and ``g ⊙ swap(x_s)`` (``swap(g) ⊙ x_s`` transposed)
    for the cotangent ``g`` of stage ``s``'s output and its input ``x_s``.
    Block ``b`` takes rows ``[b·rows/blocks, (b+1)·rows/blocks)``; its row
    slot ``u`` (of :func:`row_slots`) the rows ``u, u + slots, ...`` of
    them, added one by one from 0 in row order; the block adds its slots in
    slot order, and ``dw`` is the blocks' sums added from 0 in block order.
    On the card the kernel's ``dx`` and ``dw`` have these bits for the
    blocks of its plan."""
    p, _, n = w.shape
    wf = w.detach().to(x.dtype).float().cpu()
    t = x.detach().reshape(-1, n).float().cpu()
    gf = g.detach().reshape(-1, n).float().cpu()
    rows, slots = t.shape[0], row_slots(n)
    # idx[blk, u, m]: the m-th row of slot u of block blk; past a slot's
    # last row, an appended zero row (adding 0 leaves a sum's value)
    bounds = [k * rows // blocks for k in range(blocks + 1)]
    steps = max(-(-(bounds[k + 1] - bounds[k]) // slots)
                for k in range(blocks))
    idx = torch.full((blocks, slots, steps), rows, dtype=torch.long)
    for blk in range(blocks):
        for u in range(slots):
            mine = range(bounds[blk] + u, bounds[blk + 1], slots)
            idx[blk, u, :len(mine)] = torch.tensor(mine, dtype=torch.long)
    order = list(range(p - 1, -1, -1) if transpose else range(p))
    acts = []
    for s in order:
        acts.append(t)
        a, b = wf[s, 0], wf[s, 1]
        t = (a * t + bf.stage_swap(b * t, 1 << s) if transpose
             else a * t + b * bf.stage_swap(t, 1 << s))
    dw = torch.zeros(p, 2, n)
    for s, t in reversed(list(zip(order, acts))):
        a, b = wf[s, 0], wf[s, 1]
        if transpose:
            gs = bf.stage_swap(gf, 1 << s)
            terms = torch.stack([gf * t, gs * t], 1)
            gf = a * gf + b * gs
        else:
            terms = torch.stack([gf * t, gf * bf.stage_swap(t, 1 << s)], 1)
            gf = a * gf + bf.stage_swap(b * gf, 1 << s)
        terms = torch.cat([terms, terms.new_zeros(1, 2, n)])[idx]
        acc = torch.zeros(blocks, slots, 2, n)
        for m in range(steps):
            acc = acc + terms[:, :, m]
        total = acc[:, 0]
        for u in range(1, slots):
            total = total + acc[:, u]
        for blk in range(blocks):
            dw[s] = dw[s] + total[blk]
    dx = gf.reshape(x.shape).to(x.dtype) if need_dx else None
    return dx, dw.to(w.device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("butterfly")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.butterfly_fwd.argtypes = [p, p, p, i, i, i, i, p]
    lib.butterfly_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("butterfly_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.butterfly_bwd_plan.argtypes = [i, i, i, i, i, p]
    lib.butterfly_bwd_plan.restype = ctypes.c_int
    lib.butterfly_bwd.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.butterfly_bwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_plan(rows: int, n: int, transpose: bool, dtype: int,
              device: int) -> tuple:
    """The backward's launch plan for one shape on one device, asked once:
    (blocks, partial floats, tile-workspace floats, tile rows)."""
    sizes = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device):
        err = _bwd_lib().butterfly_bwd_plan(
            rows, n, default_segment(n.bit_length() - 1), int(transpose),
            dtype, sizes)
    if err != 0:
        raise RuntimeError(f"butterfly_bwd_plan failed with cudaError {err} "
                           f"(rows={rows}, n={n})")
    return tuple(int(v) for v in sizes)


def _check_args(x: torch.Tensor, w: torch.Tensor) -> int:
    """Validate the kernels' common arguments; returns n."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"butterfly kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"butterfly kernel takes float32 weights, got "
                        f"{w.dtype}")
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"{name}: expected device {x.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    p, n = bf._check_weights(w)
    if w.dim() != 3 or x.shape[-1] != n:
        raise ValueError(f"x {tuple(x.shape)} does not match weights "
                         f"{tuple(w.shape)}")
    if not 2 <= n <= MAX_N:
        raise ValueError(f"butterfly kernel takes 2 <= n <= {MAX_N}, got "
                         f"n={n}")
    return n


def _fwd_cuda(x: torch.Tensor, w: torch.Tensor, transpose: bool
              ) -> torch.Tensor:
    n = _check_args(x, w)
    rows = x.numel() // n
    out = torch.empty_like(x)
    if rows == 0:
        return out
    err = _lib().butterfly_fwd(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, n, int(transpose),
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"butterfly_fwd launch failed with cudaError {err}"
                           f" (rows={rows}, n={n})")
    butterfly_forward.launches += 1
    return out


def _bwd_cuda(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
              transpose: bool, need_dx: bool,
              applied: Optional[torch.Tensor]):
    n = _check_args(x, w)
    if g.dtype != x.dtype or g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    if applied is not None and (applied.dtype != torch.int32
                                or applied.device != x.device
                                or applied.numel() != 1):
        raise ValueError("applied must be one int32 on x's device")
    rows = x.numel() // n
    dev = x.device
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty(w.shape, dtype=torch.float32, device=dev)
    if rows == 0:
        return dx, dw.zero_()
    blocks, n_part, n_tiles, tile = _bwd_plan(
        rows, n, bool(transpose), _DTYPES[x.dtype], dev.index)
    partial = torch.empty(n_part, dtype=torch.float32, device=dev)
    tiles = (torch.empty(n_tiles, dtype=torch.float32, device=dev)
             if n_tiles else None)
    err = _bwd_lib().butterfly_bwd(
        x.data_ptr(), w.data_ptr(), g.data_ptr(),
        dx.data_ptr() if need_dx else None, dw.data_ptr(),
        partial.data_ptr(), tiles.data_ptr() if n_tiles else None,
        applied.data_ptr() if applied is not None else None, rows, n,
        default_segment(w.shape[0]), blocks, tile, int(transpose),
        _DTYPES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"butterfly_bwd launch failed with cudaError {err}"
                           f" (rows={rows}, n={n})")
    butterfly_backward.launches += BWD_KERNELS
    return dx, dw


def butterfly_forward(x: torch.Tensor, w: torch.Tensor, *,
                      transpose: bool = False,
                      backend: str = "auto") -> torch.Tensor:
    """``B x`` (or ``Bᵀ x``) over the last axis of ``x`` (..., n), without
    autograd. ``backend`` follows :mod:`repro_torch.kernels.context`; the
    CUDA route takes contiguous float32 or bfloat16 ``x``, float32 ``w`` on
    its device, ``2 <= n <= MAX_N`` (32,768), and counts each launch in
    ``butterfly_forward.launches``."""
    with annotate("butterfly_matmul"):
        if resolve_backend(backend, x) == "torch":
            with torch.no_grad():     # no autograd on either route
                return butterfly_plain(x, w, transpose=transpose)
        return _fwd_cuda(x, w, transpose)


butterfly_forward.launches = 0


def butterfly_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, *,
                       transpose: bool = False, need_dx: bool = True,
                       backend: str = "auto",
                       applied: Optional[torch.Tensor] = None):
    """The butterfly's VJP: ``(dx, dw)`` for the cotangent ``g`` of the
    output, ``dx`` in ``x``'s dtype or ``None`` unless ``need_dx``, ``dw``
    float32. The CUDA route adds its two launches (the row-tile VJP, the
    reduction of ``dw``) to ``butterfly_backward.launches`` and, given
    ``applied`` (one int32 on the card), writes there the number of stage
    applications the kernel performed for the first row."""
    if resolve_backend(backend, x) == "torch":
        return butterfly_bwd_plain(x, w, g, transpose=transpose,
                                   need_dx=need_dx)
    return _bwd_cuda(x, w, g, transpose, need_dx, applied)


butterfly_backward.launches = 0


class ButterflyFn(torch.autograd.Function):
    """The butterfly as one differentiable op: the forward kernel forward
    and the backward kernel backward (``route="cuda"``), or both plain twins
    (``route="torch"``). ``dx`` is computed only when ``x`` needs a
    gradient (the encoder's data does not)."""

    @staticmethod
    def forward(ctx, x, w, transpose, route):
        ctx.save_for_backward(x, w)
        ctx.transpose, ctx.route = transpose, route
        return butterfly_forward(x, w, transpose=transpose, backend=route)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = butterfly_backward(
            x, w, g.to(x.dtype).contiguous(), transpose=ctx.transpose,
            need_dx=ctx.needs_input_grad[0], backend=ctx.route)
        return dx, dw.to(w.dtype), None, None


def butterfly_apply(x: torch.Tensor, w: torch.Tensor, *,
                    transpose: bool = False,
                    backend: str = "auto") -> torch.Tensor:
    """Fused butterfly product over the last axis of ``x`` (..., n),
    differentiable in ``x`` and ``w`` through :class:`ButterflyFn`;
    ``backend`` follows :mod:`repro_torch.kernels.context`."""
    return ButterflyFn.apply(x, w, transpose, resolve_backend(backend, x))

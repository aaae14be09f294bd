"""Flash attention, forward and backward: CUDA kernels, plain twins, and
the autograd Function that joins them.

Counterpart of ``repro.kernels.flash``. ``flash_attention(q, k, v)`` takes
q/k/v ``(B, H, S, D)`` with the KV heads already expanded (the reference's
layout) and computes causal, sliding-window or full attention; the
forward also yields the row logsumexp ``lse`` ``(B·H, S)`` float32, the
one residual the backward needs besides the inputs and the output.

Precision points of the plain twins (the reference kernels'): inputs read
as float32, ``q`` pre-scaled by ``D^-0.5``, every product and the softmax
state in float32, ``o``, ``dq``, ``dk``, ``dv`` rounded to the input dtype
once at the end. The kernels differ from them only by reordering: the
products on tensor cores (bfloat16 inputs exact, p and ds as hi/lo
bfloat16 pairs; float32 in 3xTF32), p in base 2 with the scale applied
after the product (``csrc/flash.cu``, ``csrc/flash_bwd.cu``;
``tests/test_torch_flash.py`` emulates them). ``Δ = rowsum(dO ⊙ O)`` is
computed in float32 by plain PyTorch outside the kernels, as the
reference computes it outside its ``pallas_call``\\ s. The
mask: key ``k`` is visible from query ``q`` when ``k <= q`` (causal) and
``k > q - window`` (``window > 0``; with ``causal=False`` only this lower
bound applies).

The CUDA route: ``csrc/flash.cu`` (one launch forward) and
``csrc/flash_bwd.cu`` (two launches backward, dq then dk/dv). Two choices
of the reference do not carry over:

* The reference's ``block_q``/``block_kv`` come from a TPU VMEM model
  (``tuning.flash_blocks``). The kernels' tiles are their own: 64 rows
  swept, and the rows a backward block owns from :func:`tile_rows`, as
  the built library reports them. The tile rule records them
  (:func:`repro_torch.kernels.tuning.flash_blocks`, its model of
  ``BwdSplit``), and takes no override for them.
* The reference asserts ``S % block == 0`` but its default blocks fall back
  to ``gcd(S, 8)``, so it takes any ``S``. The kernels take any
  ``S >= 1`` and mask the ragged last tile themselves, and head dims 8 to
  256 in steps of 8; the wrappers raise for anything else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, tuning
from repro_torch.kernels.context import (ContextLike, resolve_execution,
                                         route_context, tensor_route)
from repro_torch.obs.profiling import annotate

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD_KERNELS = 2           # dq, then dk and dv


def tile_rows(head_dim: int, dtype: torch.dtype = torch.float32) -> tuple:
    """``(block_q, block_kv)``: the rows a block of the dq kernel (query
    rows) and of the dkv kernel (key rows) owns at ``head_dim`` in
    ``dtype``, 64 or 32 (the tiles they sweep are 64 rows), as the built
    library reports them (``flash_common.cuh`` ``BwdSplit``); raises for a
    head dim or dtype the kernels do not take."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash kernels take float32 or bfloat16, got "
                        f"{dtype}")
    rows = tuple(_lib().flash_tile_rows(int(head_dim), _DTYPES[dtype], dkv)
                 for dkv in (0, 1))
    if min(rows) <= 0:
        raise ValueError(f"flash kernels take head dims 8..256 in steps of "
                         f"8, got D={head_dim}")
    return rows


def visible_mask(S: int, causal: bool, window: int,
                 device=None) -> torch.Tensor:
    """(S, S) bool, ``[q, k]`` true where key ``k`` is visible from query
    ``q``."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = torch.ones(S, S, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def _scale(D: int) -> float:
    """D^-0.5 rounded to float32, the number both routes scale q by."""
    return float(torch.tensor(D ** -0.5, dtype=torch.float32))


def _scores(q: torch.Tensor, k: torch.Tensor):
    """(scaled float32 q, float32 q·kᵀ) over (B, H, S, D)."""
    qf = q.float() * _scale(q.shape[-1])
    return qf, qf @ k.float().transpose(-1, -2)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0):
    """Plain twin of the forward kernel: ``(out, lse)``, ``out`` in ``q``'s
    dtype, ``lse`` float32 ``(B·H, S)``."""
    B, H, S, D = q.shape
    _, s = _scores(q, k)
    mask = visible_mask(S, causal, window, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (p @ v.float()) / l
    lse = (m + torch.log(l)).reshape(B * H, S)
    return out.to(q.dtype), lse


def row_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO ⊙ O) in float32, (B·H, S)."""
    B, H, S, _ = out.shape
    return (do.float() * out.float()).sum(-1).reshape(B * H, S)


def _probs(q, k, lse, causal, window):
    """(scaled float32 q, p = exp(s − lse) on visible entries, 0 else)."""
    B, H, S, _ = q.shape
    qf, s = _scores(q, k)
    p = torch.exp(s - lse.reshape(B, H, S, 1))
    return qf, p.masked_fill(~visible_mask(S, causal, window, q.device), 0.0)


def flash_dq_plain(q, k, v, do, lse, delta, causal=True, window=0):
    """Plain twin of the dq kernel: ``ds = p ⊙ (dO·vᵀ − Δ)``, ``dq = ds·k
    · D^-0.5`` in ``q``'s dtype."""
    B, H, S, D = q.shape
    _, p = _probs(q, k, lse, causal, window)
    ds = p * (do.float() @ v.float().transpose(-1, -2)
              - delta.reshape(B, H, S, 1))
    return ((ds @ k.float()) * _scale(D)).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal=True, window=0):
    """Plain twin of the dkv kernel: ``dv = pᵀ·dO``, ``dk = dsᵀ·(q ·
    D^-0.5)``, in ``k``'s and ``v``'s dtype."""
    B, H, S, D = q.shape
    qf, p = _probs(q, k, lse, causal, window)
    dof = do.float()
    ds = p * (dof @ v.float().transpose(-1, -2) - delta.reshape(B, H, S, 1))
    pt = p.transpose(-1, -2)
    return ((ds.transpose(-1, -2) @ qf).to(k.dtype),
            (pt @ dof).to(v.dtype))


def flash_bwd_plain(q, k, v, out, lse, do, causal=True, window=0):
    """Plain twin of the backward: ``(dq, dk, dv)`` from the forward's
    ``out`` and ``lse`` and the output cotangent ``do``."""
    delta = row_delta(out, do)
    dk, dv = flash_dkv_plain(q, k, v, do, lse, delta, causal, window)
    return flash_dq_plain(q, k, v, do, lse, delta, causal, window), dk, dv


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd.argtypes = [p] * 5 + [i] * 5 + [f, i, p]
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_tile_rows.argtypes = [i, i, i]
    lib.flash_tile_rows.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_bwd_dq.argtypes = [p] * 7 + [i] * 5 + [f, i, p]
    lib.flash_bwd_dq.restype = ctypes.c_int
    lib.flash_bwd_dkv.argtypes = [p] * 8 + [i] * 5 + [f, i, p]
    lib.flash_bwd_dkv.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, *others: torch.Tensor) -> tuple:
    """Validate the kernels' (B, H, S, D) operands; returns the shape."""
    if q.dim() != 4:
        raise ValueError(f"flash kernels take (B, H, S, D), got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    B, H, S, D = q.shape
    for t in (q, *others):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash operands must share shape, dtype and "
                             f"device: {tuple(t.shape)} {t.dtype} {t.device}"
                             f" vs {tuple(q.shape)} {q.dtype} {q.device}")
        if not t.is_contiguous():
            raise ValueError("flash operands must be contiguous")
    if not (8 <= D <= 256 and D % 8 == 0):
        raise ValueError(f"flash kernels take head dims 8..256 in steps of "
                         f"8, got D={D}")
    if S < 1 or B * H < 1:
        raise ValueError(f"flash kernels need S >= 1 and B·H >= 1, got "
                         f"{tuple(q.shape)}")
    return B, H, S, D


def _check_rows(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    B, H, S, _ = q.shape
    if (t.shape != (B * H, S) or t.dtype != torch.float32
            or t.device != q.device or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous float32 (B·H, S) = "
                         f"{(B * H, S)} on {q.device}, got {tuple(t.shape)} "
                         f"{t.dtype} {t.device}")


def _raise_on(err: int, what: str, q: torch.Tensor) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError {err} "
                           f"(q {tuple(q.shape)} {q.dtype})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_aligned(what: str, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:     # the kernels copy 16-byte chunks
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _fwd_cuda(q, k, v, causal, window):
    B, H, S, D = _check(q, k, v)
    _check_aligned("flash forward", q=q, k=k, v=v)
    tuning.tune("flash", D, q.dtype, "fwd")
    out = torch.empty_like(q)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    err = _lib().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B * H, S, D, int(causal), int(window), _scale(D),
        _DTYPES[q.dtype], _stream(q))
    _raise_on(err, "flash_fwd", q)
    flash_forward.launches += 1
    return out, lse


def dq_cuda(q, k, v, do, lse, delta, causal=True, window=0):
    """One launch of the dq kernel (``flash_backward`` runs it, then
    :func:`dkv_cuda`); adds 1 to ``flash_backward.launches``."""
    B, H, S, D = _check(q, k, v, do)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    _check_aligned("flash_bwd_dq", q=q, k=k, v=v, do=do)
    tuning.tune("flash", D, q.dtype, "bwd")
    dq = torch.empty_like(q)
    err = _bwd_lib().flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H, S, D,
        int(causal), int(window), _scale(D), _DTYPES[q.dtype], _stream(q))
    _raise_on(err, "flash_bwd_dq", q)
    flash_backward.launches += 1
    return dq


def dkv_cuda(q, k, v, do, lse, delta, causal=True, window=0):
    """One launch of the dkv kernel; adds 1 to
    ``flash_backward.launches``. Returns ``(dk, dv)``."""
    B, H, S, D = _check(q, k, v, do)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    _check_aligned("flash_bwd_dkv", q=q, k=k, v=v, do=do)
    tuning.tune("flash", D, q.dtype, "bwd")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _bwd_lib().flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B * H, S, D, int(causal), int(window), _scale(D), _DTYPES[q.dtype],
        _stream(q))
    _raise_on(err, "flash_bwd_dkv", q)
    flash_backward.launches += 1
    return dk, dv


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  context: ContextLike = None):
    """``(out, lse)`` without autograd. ``context`` follows
    :mod:`repro_torch.kernels.context`; the CUDA route takes contiguous
    float32 or bfloat16 q/k/v of one shape (B, H, S, D) with ``D`` in
    8..256 (a multiple of 8), and counts its launch in
    ``flash_forward.launches``."""
    if tensor_route(resolve_execution(context).backend, q) == "torch":
        with torch.no_grad():
            return flash_fwd_plain(q, k, v, causal, window)
    return _fwd_cuda(q, k, v, causal, window)


flash_forward.launches = 0


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   context: ContextLike = None):
    """``(dq, dk, dv)`` for the cotangent ``do`` of the forward's ``out``
    (``lse`` its logsumexp). The CUDA route computes Δ in plain PyTorch and
    launches the dq and the dkv kernel, adding 2 to
    ``flash_backward.launches``."""
    if tensor_route(resolve_execution(context).backend, q) == "torch":
        with torch.no_grad():
            return flash_bwd_plain(q, k, v, out, lse, do, causal, window)
    _check(q, k, v, out, do)
    delta = row_delta(out, do)
    dq = dq_cuda(q, k, v, do, lse, delta, causal, window)
    dk, dv = dkv_cuda(q, k, v, do, lse, delta, causal, window)
    return dq, dk, dv


flash_backward.launches = 0


class FlashFn(torch.autograd.Function):
    """Flash attention as one differentiable op: the forward kernel forward
    and the two backward kernels backward (``route="cuda"``), or the plain
    twins (``route="torch"``). Saves ``(q, k, v, out, lse)``, as the
    reference's ``_flash_diff_fwd`` does; the (S, S) probabilities are
    recomputed, never stored."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, route):
        out, lse = flash_forward(q, k, v, causal=causal, window=window,
                                 context=route_context(route))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.route = causal, window, route
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(
            q, k, v, out, lse, g.to(q.dtype).contiguous(), causal=ctx.causal,
            window=ctx.window, context=route_context(ctx.route))
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    context: ContextLike = None) -> torch.Tensor:
    """q/k/v (B, H, S, D), KV heads already expanded; differentiable in all
    three through :class:`FlashFn`. ``context`` follows
    :mod:`repro_torch.kernels.context`: the kernels for a CUDA tensor, the
    plain twins for a CPU tensor, no fallback from one to the other."""
    ctx = resolve_execution(context)
    with annotate("flash_attention", ctx):
        return FlashFn.apply(q, k, v, causal, int(window),
                             tensor_route(ctx.backend, q))

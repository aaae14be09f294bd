"""Paged-gather decode attention: plain oracle, CUDA kernel, wrapper.

Counterpart of ``repro.kernels.paged_attention``. KV lives in one pool of
fixed-size pages ``(num_pages, page_size, KV, D)``; a per-slot page table
maps logical page ``j`` (absolute positions ``[j·ps, (j+1)·ps)``) to a
physical page.

* :func:`paged_attend_ref` — the plain gather oracle: materialize
  ``pool[page_table]`` and run masked GQA attention in float32. Supports
  ``Sq >= 1`` queries (chunked prefill reads through it).
* :func:`paged_decode_attention` — single-query decode; on a CUDA tensor it
  launches ``csrc/paged_attention.cu``: a split kernel over runs of
  :func:`pages_per_split` pages, then a combine of the runs' partial states
  (``PAGED_KERNELS`` launches a call).
* :func:`paged_decode_split_plain` — the plain twin of that split: each
  run's partial state (m, l, acc) over its live positions, merged over the
  live runs. Held against the oracle and the reference's kernel; the
  CPU route of :func:`paged_decode_attention` stays the oracle.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.context import (ContextLike, resolve_execution,
                                         tensor_route)
from repro_torch.obs.profiling import annotate

NEG_INF = -1e30

# physical page 0 is reserved: never handed out by the allocator, the
# target of every unmapped page-table entry and every out-of-range scatter.
# Its contents are garbage by design; the positional mask keeps them out.
TRASH_PAGE = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PAGED_KERNELS = 2         # split over runs of pages, then the combine
ROWS_PER_SPLIT = 64       # positions of one run: 4 pages of 16
MAX_RUNS = 512            # runs per slot, at most (the combine's table)
MAX_GROUP = 16            # query heads per KV head the kernel takes


def pages_per_split(page_size: int, pages: int) -> int:
    """Pages of one run of the split kernel for a page table of ``pages``
    pages: ``ROWS_PER_SPLIT`` positions' worth, at least one page, and
    enough that a slot has at most ``MAX_RUNS`` runs."""
    return max(1, ROWS_PER_SPLIT // page_size, -(-pages // MAX_RUNS))


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """Logical per-slot KV view: (N, ps, KV, D) + (B, P) -> (B, P·ps, KV, D),
    in absolute-position order."""
    B, P = page_table.shape
    _, ps, KV, D = pool.shape
    return pool[page_table.long()].reshape(B, P * ps, KV, D)


def paged_attend_ref(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, page_table: torch.Tensor,
                     q_pos: torch.Tensor) -> torch.Tensor:
    """Plain gather oracle. q (B, Sq, KV, G, D); pools (N, ps, KV, D);
    page_table (B, P) int; q_pos (B, Sq) absolute query positions.
    Returns (B, Sq, KV, G, D) in ``q``'s dtype.

    Causal over absolute positions: a query at ``t`` sees cached positions
    ``<= t``. Positions past a row's last query (trash-page garbage,
    recycled-page leftovers, pad tails) are masked out of the scores and
    zeroed in V, so even NaN there cannot reach the output. Scores, softmax
    and the weighted sum run in float32, the precision points of the
    reference's decode kernel, and the result is cast once at the end.
    """
    B, Sq, KV, G, D = q.shape
    ka = gather_pages(k_pool, page_table).to(q.dtype).float()
    va = gather_pages(v_pool, page_table).to(q.dtype).float()
    L = ka.shape[1]
    kpos = torch.arange(L, device=q.device)
    q_pos = q_pos.long()
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.float(), ka) * D ** -0.5
    valid = kpos[None, None, :] <= q_pos[:, :, None]          # (B, Sq, L)
    logits = logits.masked_fill(~valid[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    seen = kpos[None, :] <= q_pos.max(dim=1).values[:, None]  # (B, L)
    va = va.masked_fill(~seen[:, :, None, None], 0)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, va).to(q.dtype)


def paged_decode_split_plain(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, page_table: torch.Tensor,
                             cur_pos: torch.Tensor,
                             pages_per_split: int) -> torch.Tensor:
    """Plain twin of the split decode. q (B, KV, G, D); pools (N, ps, KV,
    D); page_table (B, P) int; cur_pos (B,) int. Positions split into runs
    of ``pages_per_split`` pages; run ``r`` keeps, over its live positions
    (``kpos <= cur_pos``), ``m_r`` = the max score, ``l_r`` = Σ exp(s − m_r)
    and ``acc_r`` = Σ exp(s − m_r)·v; the output is Σ_r w_r·acc_r /
    Σ_r w_r·l_r with ``w_r = exp(m_r − max_r m_r)`` over the live runs, in
    float32, cast once. Positions past cur_pos enter neither scores nor V,
    so NaN there cannot reach the output; a slot with cur_pos < 0 gets
    zeros. Returns (B, KV, G, D) in ``q``'s dtype."""
    B, KV, G, D = q.shape
    ps = k_pool.shape[1]
    P = page_table.shape[1]
    runs = -(-P // pages_per_split)
    R, L = pages_per_split * ps, P * ps
    kpos = torch.arange(runs * R, device=q.device)
    live = kpos[None, :] <= cur_pos.long().clamp(max=L - 1)[:, None]

    def rows(pool):                                   # (B, runs·R, KV, D)
        x = gather_pages(pool, page_table).to(q.dtype).float()
        x = torch.cat([x, x.new_zeros(B, runs * R - L, KV, D)], dim=1)
        return x.masked_fill(~live[:, :, None, None], 0.0)

    ka, va = rows(k_pool), rows(v_pool)
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), ka) * D ** -0.5
    run_live = live.reshape(B, 1, 1, runs, R)
    s = s.reshape(B, KV, G, runs, R).masked_fill(~run_live, NEG_INF)
    m = s.amax(dim=-1)                                # (B, KV, G, runs)
    p = torch.exp(s - m[..., None]).masked_fill(~run_live, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgnr,bnrkd->bkgnd", p,
                       va.reshape(B, runs, R, KV, D))
    any_live = run_live.any(dim=-1)                   # (B, 1, 1, runs)
    m = m.masked_fill(~any_live, NEG_INF)
    w = torch.exp(m - m.amax(dim=-1, keepdim=True)).masked_fill(~any_live,
                                                                0.0)
    out = ((acc * w[..., None]).sum(dim=-2)
           / (l * w).sum(dim=-1).clamp_min(1e-30)[..., None])
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_decode.argtypes = [p] * 7 + [i] * 7 + [f, i, p]
    lib.paged_decode.restype = ctypes.c_int
    return lib


def _paged_decode_cuda(q, k_pool, v_pool, page_table, cur_pos):
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    dev = q.device
    for name, t, dt in (("q", q, q.dtype), ("k_pool", k_pool, q.dtype),
                        ("v_pool", v_pool, q.dtype),
                        ("page_table", page_table, torch.int32),
                        ("cur_pos", cur_pos, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: expected device {dev}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, KV, G, D = q.shape
    N, ps, KV2, D2 = k_pool.shape
    P = page_table.shape[1]
    if (KV2, D2) != (KV, D) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.shape != (B, P) or cur_pos.shape != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / cur_pos "
                         f"{tuple(cur_pos.shape)} do not match batch {B}")
    if not (8 <= D <= 256 and D % 8 == 0) or G > MAX_GROUP:
        raise ValueError(f"paged kernel takes head dims 8..256 in steps of 8"
                         f" and at most {MAX_GROUP} query heads per KV head, "
                         f"got D={D}, G={G}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    pps = pages_per_split(ps, P)
    runs = -(-P // pps)
    out = torch.empty_like(q)
    part = torch.empty(B * KV * runs * G * (D + 2), dtype=torch.float32,
                       device=dev)
    err = _lib().paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), cur_pos.data_ptr(), out.data_ptr(),
        part.data_ptr(), B, KV, G, D, ps, P, pps, float(D ** -0.5),
        _DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode launch failed with cudaError {err} "
                           f"(B={B}, KV={KV}, G={G}, D={D}, ps={ps})")
    paged_decode_attention.launches += PAGED_KERNELS
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           cur_pos: torch.Tensor, *,
                           context: ContextLike = None) -> torch.Tensor:
    """Single-query paged decode attention. q (B, KV, G, D); pools
    (N, ps, KV, D); page_table (B, P) int32; cur_pos (B,) int32 absolute
    positions. ``context=None`` resolves from this thread's ambient
    :class:`~repro_torch.kernels.context.ExecutionContext`, as every entry
    point does. The CUDA route (two launches: the split over runs of pages,
    then the combine) counts its launches in
    ``paged_decode_attention.launches``."""
    ctx = resolve_execution(context)
    with annotate("paged_attention", ctx):
        if tensor_route(ctx.backend, q) == "torch":
            return paged_attend_ref(q[:, None], k_pool, v_pool, page_table,
                                    cur_pos[:, None])[:, 0]
        return _paged_decode_cuda(q, k_pool, v_pool, page_table, cur_pos)


paged_decode_attention.launches = 0

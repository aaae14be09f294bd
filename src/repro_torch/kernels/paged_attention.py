"""Paged-gather decode attention: plain oracle, CUDA kernel, wrapper.

Counterpart of ``repro.kernels.paged_attention``. KV lives in one pool of
fixed-size pages ``(num_pages, page_size, KV, D)``; a per-slot page table
maps logical page ``j`` (absolute positions ``[j·ps, (j+1)·ps)``) to a
physical page.

* :func:`paged_attend_ref` — the plain gather oracle: materialize
  ``pool[page_table]`` and run masked GQA attention in float32. Supports
  ``Sq >= 1`` queries (chunked prefill reads through it).
* :func:`paged_decode_attention` — single-query decode; on a CUDA tensor it
  launches ``csrc/paged_attention.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.context import resolve_backend

NEG_INF = -1e30

# physical page 0 is reserved: never handed out by the allocator, the
# target of every unmapped page-table entry and every out-of-range scatter.
# Its contents are garbage by design; the positional mask keeps them out.
TRASH_PAGE = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_decode.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, f, i, p]
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
    out = torch.empty_like(q)
    err = _lib().paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), cur_pos.data_ptr(), out.data_ptr(), B, KV, G,
        D, ps, P, float(D ** -0.5), _DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode launch failed with cudaError {err} "
                           f"(B={B}, KV={KV}, G={G}, D={D}, ps={ps})")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           cur_pos: torch.Tensor, *,
                           backend: str = "auto") -> torch.Tensor:
    """Single-query paged decode attention. q (B, KV, G, D); pools
    (N, ps, KV, D); page_table (B, P) int32; cur_pos (B,) int32 absolute
    positions. The CUDA route counts each launch in
    ``paged_decode_attention.launches``."""
    if resolve_backend(backend, q) == "torch":
        return paged_attend_ref(q[:, None], k_pool, v_pool, page_table,
                                cur_pos[:, None])[:, 0]
    return _paged_decode_cuda(q, k_pool, v_pool, page_table, cur_pos)


paged_decode_attention.launches = 0

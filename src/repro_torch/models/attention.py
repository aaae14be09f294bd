"""GQA attention: over the paged KV pool and over dense rows and
sliding-window rings (serving), over whole sequences without a cache
(training), bidirectional over an encoder's frames, and across to an
encoder's output.

Counterpart of ``repro.models.attention.attention``.

* **Training** (no cache): the masked path :func:`_attend_masked`, or the
  online-softmax blockwise path :func:`_attend_blockwise` from
  ``cfg.blockwise_threshold`` on, both with the sliding ``window`` of a
  ``local`` block, and without the causal mask for an ``enc`` block
  (``causal=False``). Training's blockwise loop visits every KV block and
  masks; a block outside the causal window contributes exactly zero
  through ``corr = exp(m - m_new)``.
* **Prefill** (``prefill=True``): the whole prompt at once, the blockwise
  path skipping the KV blocks outside each query block's window (the
  reference's ``dynamic_bounds``); the layer's dense cache row is written
  in place. A ring (``window > 0``) keeps the last ``ring`` positions with
  ``slot = pos % ring``; a full row keeps the prompt and zeros after it.
* **Paged decode** (``page_table`` given, ``window == 0``): scatter this
  step's K/V into the pool at ``(page, offset)`` — positions past the page
  table's reach go to the trash page — and read back through the page
  table. One query position goes to the CUDA kernel; a prompt chunk
  (``Sq > 1``) goes to the plain gather :func:`paged_attend_ref`, as the
  reference does. An ``xdec`` block's self-attention takes this branch as
  an ``attn`` block's does.
* **Dense decode** (otherwise): one query position per row, written at
  ``cur_pos % ring`` into a ring or at ``cur_pos`` into a full row, read
  back under a validity mask that rebuilds each ring entry's absolute
  position. Plain PyTorch, as the reference's is plain jnp: the reference
  has no ring-decode kernel.
* **Cross-attention** (:func:`cross_attention`, an ``xdec`` block's second
  attention): keys and values from the encoder's output, no RoPE, no mask.
  A prefill writes the layer's cross rows (the slot's ``enc_seq`` rows) in
  place; a decode step reads all of them and writes nothing. Plain
  PyTorch, as the reference's is plain jnp.

Every cache is updated in place and no branch synchronises with the host,
so a decode tick captures as one CUDA graph.

:func:`kv_layout` is the reference's one K/V and cache layout on the
ambient mesh. The port holds K/V whole on every rank (it has no tensor
parallelism): the layout names the logical axes the launch accounting
(:mod:`repro_torch.launch.specs`) shards the caches by.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.context import ContextLike
from repro_torch.models import common as cm
from repro_torch.nn.linear import scaled_normal
from repro_torch.runtime import loops


def kv_layout(cfg: ModelConfig, mode: str) -> Tuple:
    """The logical axes of K/V and of the cache, ``(batch, seq, kv_heads,
    head_dim)``, on the ambient sharding context's mesh
    (:func:`repro_torch.runtime.sharding.active_ctx`), as the reference's:
    the KV heads over ``model`` when that axis divides them, else the
    sequence (``seq_kv``) outside training."""
    from repro_torch.runtime.sharding import active_ctx
    ctx = active_ctx()
    kv_ok = False
    if (ctx is not None and ctx.mesh is not None
            and "model" in ctx.mesh.shape):
        kv_ok = cfg.n_kv_heads % ctx.mesh.shape["model"] == 0
    if kv_ok:
        return ("batch", None, "kv_heads", None)
    if mode == "train":
        return ("batch", None, None, None)
    return ("batch", "seq_kv", None, None)


class Attention(nn.Module):
    """Projection weights in the reference's layout: ``wq`` (E, H, D),
    ``wk``/``wv`` (E, KV, D), ``wo`` (H, D, E)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        E, H, KV, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        dt = cfg.pdtype()
        self.wq = nn.Parameter(scaled_normal(generator, (E, H, D), E).to(dt))
        self.wk = nn.Parameter(scaled_normal(generator, (E, KV, D), E).to(dt))
        self.wv = nn.Parameter(scaled_normal(generator, (E, KV, D), E).to(dt))
        self.wo = nn.Parameter(scaled_normal(generator, (H, D, E), D).to(dt))


NEG_INF = -1e30


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, E) x (E, h, D) -> (B, S, h, D)."""
    E, h, D = w.shape
    return (x @ w.to(x.dtype).reshape(E, h * D)).view(*x.shape[:2], h, D)


def _attend_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: Optional[torch.Tensor],
                   k_pos: Optional[torch.Tensor], window: int = 0,
                   causal: bool = True) -> torch.Tensor:
    """Grouped-query attention without KV expansion: q (B,Sq,KV,G,D),
    k/v (B,Skv,KV,D), positions (B,S); ``causal`` masks keys after the
    query, ``window > 0`` keys ``window`` or more positions back. Without
    either nothing is masked and the positions may be ``None``. Scores and
    softmax in float32."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    if causal or window > 0:
        kp = k_pos[:, None, None, None, :]
        qp = q_pos[:, None, None, :, None]
        mask = kp <= qp if causal else kp > qp - window
        if causal and window > 0:
            mask &= kp > qp - window
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)


def _attend_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      block_q: int, block_kv: int, window: int = 0,
                      causal: bool = True,
                      dynamic_bounds: bool = False) -> torch.Tensor:
    """Online-softmax GQA attention over (block_q, block_kv) tiles.
    q (B,S,KV,G,D), k/v (B,S,KV,D); S divides both blocks; ``causal``
    masks keys after the query, ``window > 0`` is a sliding window.
    Training (``dynamic_bounds=False``) visits every KV block of every
    query block and masks; prefill visits only the blocks that intersect
    ``[qi*bq - window, (qi+1)*bq)`` (every block past it too when not
    ``causal``), the reference's block skipping. The bounds are Python
    ints: no host sync."""
    B, S, KV, G, D = q.shape
    scale = D ** -0.5
    dev = q.device
    nkv = S // block_kv
    outs = []
    for qi in range(S // block_q):
        lo, hi = 0, nkv
        if dynamic_bounds:
            if causal:
                hi = (qi * block_q + block_q + block_kv - 1) // block_kv
            if window > 0:
                lo = max(0, (qi * block_q - window) // block_kv)
        qblk = q[:, qi * block_q:(qi + 1) * block_q].permute(0, 2, 3, 1, 4)
        q_ids = qi * block_q + torch.arange(block_q, device=dev)
        m = torch.full((B, KV, G, block_q), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, block_q), device=dev)
        acc = torch.zeros((B, KV, G, block_q, D), device=dev)
        for j in loops.steps(hi - lo):
            j += lo
            sl = slice(j * block_kv, (j + 1) * block_kv)
            kblk = k[:, sl].permute(0, 2, 1, 3)          # (B,KV,bkv,D)
            vblk = v[:, sl].permute(0, 2, 1, 3)
            k_ids = j * block_kv + torch.arange(block_kv, device=dev)
            s = torch.einsum("bkgqd,bkcd->bkgqc", qblk, kblk).float() * scale
            msk = torch.ones((block_q, block_kv), dtype=torch.bool,
                             device=dev)
            if causal:
                msk &= k_ids[None, :] <= q_ids[:, None]
            if window > 0:
                msk &= k_ids[None, :] > q_ids[:, None] - window
            s = s.masked_fill(~msk, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bkcd->bkgqd", p.to(vblk.dtype), vblk).float()
            m = m_new
        out = acc / l.clamp(min=1e-30)[..., None]
        outs.append(out.to(q.dtype))                   # (B,KV,G,bq,D)
    return torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)


def attention(cfg: ModelConfig, attn: Attention, x: torch.Tensor, *,
              positions: torch.Tensor,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              page_table: Optional[torch.Tensor] = None,
              window: int = 0, prefill: bool = False, causal: bool = True,
              context: ContextLike = None) -> torch.Tensor:
    """x (B, Sq, E); positions (B, Sq) int32 absolute positions; ``window``
    the sliding window of a ``local`` block (0 = full attention);
    ``causal=False`` for an ``enc`` block, which runs without a cache.

    Without ``cache``: attention over the whole sequence (training). With
    ``cache``, this layer's ``(k, v)``, written in place: under ``prefill``
    a dense row or ring (B, length, KV, D) filled from the whole prompt;
    with ``page_table`` (B, P) int32 and ``window == 0`` the paged pool
    (N, ps, KV, D); else a dense row or ring at one decode position per
    row, ``positions[:, 0]``."""
    B, Sq, E = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = cm.rope(_project(x, attn.wq), positions, cfg.rope_theta)
    q = q.view(B, Sq, KV, H // KV, D)            # grouped-query layout
    k = cm.rope(_project(x, attn.wk), positions, cfg.rope_theta)
    v = _project(x, attn.wv)

    if cache is None or prefill:
        if cache is not None:
            _write_prefill(cache, k, v, window)
        if (Sq >= cfg.blockwise_threshold and Sq % cfg.attn_block_q == 0
                and Sq % cfg.attn_block_kv == 0):
            att = _attend_blockwise(q, k, v, block_q=cfg.attn_block_q,
                                    block_kv=cfg.attn_block_kv,
                                    window=window, causal=causal,
                                    dynamic_bounds=prefill)
        else:
            att = _attend_masked(q, k, v, positions, positions, window,
                                 causal)
        return _proj_out(cfg, attn, att)

    if page_table is None or window > 0:
        return _proj_out(cfg, attn, _decode_dense(q, k, v, cache,
                                                  positions, window))

    k_pool, v_pool = cache
    ps = k_pool.shape[1]
    P = page_table.shape[1]
    logical = positions // ps
    pages = torch.gather(page_table, 1, logical.clamp(max=P - 1).long())
    pages = torch.where(logical < P, pages, pa.TRASH_PAGE).long()
    offs = (positions % ps).long()
    k_pool[pages, offs] = k.to(k_pool.dtype)
    v_pool[pages, offs] = v.to(v_pool.dtype)
    if Sq == 1:
        att = pa.paged_decode_attention(
            q[:, 0].contiguous(), k_pool, v_pool, page_table,
            positions[:, 0].contiguous(), context=context)[:, None]
    else:
        att = pa.paged_attend_ref(q, k_pool, v_pool, page_table, positions)
    return _proj_out(cfg, attn, att)


def cross_attention(cfg: ModelConfig, attn: Attention, x: torch.Tensor, *,
                    enc_out: Optional[torch.Tensor] = None,
                    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    prefill: bool = False) -> torch.Tensor:
    """An ``xdec`` block's attention across to the encoder: x (B, Sq, E)
    queries without RoPE; keys and values projected from ``enc_out`` (B,
    S_enc, E), unmasked. ``cache`` is the layer's cross rows (B, enc_seq,
    KV, D): under ``prefill`` they are written from ``enc_out`` in place
    (zeros past ``S_enc``, as the reference pads them); with a cache and no
    ``prefill`` (decode) the step reads all ``enc_seq`` rows, as the
    reference reads them, and writes nothing. Plain PyTorch: the
    reference's cross-attention is plain jnp."""
    B, Sq, E = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = _project(x, attn.wq).view(B, Sq, KV, H // KV, D)
    if cache is not None and not prefill:
        k, v = (c.to(q.dtype) for c in cache)
    else:
        k, v = _project(enc_out, attn.wk), _project(enc_out, attn.wv)
        if cache is not None:
            _write_prefill(cache, k, v, 0)
    return _proj_out(cfg, attn, _attend_masked(q, k, v, None, None,
                                               causal=False))


def _write_prefill(cache: Tuple[torch.Tensor, torch.Tensor],
                   k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    """Fill a dense cache row (B, length, KV, D) from a whole prompt's k/v
    (B, Sq, KV, D), in place. A ring (``window > 0``) of a prompt at least
    as long keeps its last ``length`` positions, rolled so that ``slot =
    pos % length``; a shorter prompt, or a full row, lands at slots
    ``0..Sq-1`` with zeros after it. The zero tail is never read: decode's
    validity mask admits a slot only once its position has been written."""
    length, Sq = cache[0].shape[1], k.shape[1]
    for c, new in zip(cache, (k, v)):
        new = new.to(c.dtype)
        if window > 0 and Sq >= length:
            start = Sq - length
            c.copy_(torch.roll(new[:, start:], start % length, dims=1))
        else:
            c[:, :Sq] = new
            c[:, Sq:] = 0


def _decode_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cache: Tuple[torch.Tensor, torch.Tensor],
                  positions: torch.Tensor, window: int) -> torch.Tensor:
    """One decode position per row against a dense cache row (B, length,
    KV, D): write k/v at ``cur_pos % length`` (a ring, ``window > 0``) or at
    ``cur_pos``, then attend over the row. A ring entry ``i`` holds the
    absolute position ``p <= cur_pos`` with ``p % length == i``; it is valid
    when ``p > cur_pos - window``. Returns (B, 1, KV, G, D)."""
    if q.shape[1] != 1:
        raise ValueError(f"dense-cache decode takes one query position per "
                         f"row, got {q.shape[1]}")
    k_all, v_all = cache
    B, length = k_all.shape[:2]
    cp = positions[:, 0].long()
    slot = cp % length if window > 0 else cp
    rows = torch.arange(B, device=q.device)
    k_all[rows, slot] = k[:, 0].to(k_all.dtype)
    v_all[rows, slot] = v[:, 0].to(v_all.dtype)
    kpos = torch.arange(length, device=q.device)[None, :]
    cp = cp[:, None]
    if window > 0:
        abs_pos = kpos + (cp - cp % length)
        abs_pos = torch.where(abs_pos > cp, abs_pos - length, abs_pos)
        valid = abs_pos >= (cp - window + 1).clamp(min=0)
    else:
        valid = kpos <= cp
    scale = q.shape[-1] ** -0.5
    ka, va = k_all.to(q.dtype), v_all.to(q.dtype)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, ka).float() * scale
    logits = logits.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", probs.to(va.dtype), va)


def _proj_out(cfg: ModelConfig, attn: Attention, att: torch.Tensor
              ) -> torch.Tensor:
    """att (B, S, KV, G, D) grouped layout -> (B, S, E)."""
    B, S = att.shape[:2]
    H, D, E = attn.wo.shape
    return att.reshape(B, S, H * D) @ attn.wo.to(att.dtype).reshape(H * D, E)

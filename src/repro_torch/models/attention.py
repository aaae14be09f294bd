"""GQA attention: over the paged KV pool (serving) and over whole
sequences without a cache (training).

Counterpart of ``repro.models.attention.attention`` for two of its
branches. Serving: project q/k/v, apply RoPE, scatter this step's K/V into
the pool at ``(page, offset)`` — positions past the page table's reach go
to the trash page — and read back through the page table. One query
position (``Sq == 1``, decode) goes to the CUDA kernel; a prompt chunk
(``Sq > 1``) goes to the plain gather :func:`paged_attend_ref`, exactly as
the reference does. The pool is updated in place. Training (no cache): the
causal masked path :func:`_attend_masked`, or the online-softmax blockwise
path :func:`_attend_blockwise` from ``cfg.blockwise_threshold`` on. Both
are plain PyTorch, as the reference's are plain jnp.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import common as cm
from repro_torch.nn.linear import scaled_normal


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
                   q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """Causal grouped-query attention without KV expansion: q (B,Sq,KV,G,D),
    k/v (B,Skv,KV,D), positions (B,S). Scores and softmax in float32."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    mask = k_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)


def _attend_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      block_q: int, block_kv: int) -> torch.Tensor:
    """Online-softmax causal GQA attention over (block_q, block_kv) tiles,
    the reference's training variant: every KV block of every query block,
    masked (no block skipping). q (B,S,KV,G,D), k/v (B,S,KV,D); S divides
    both blocks."""
    B, S, KV, G, D = q.shape
    scale = D ** -0.5
    dev = q.device
    outs = []
    for qi in range(S // block_q):
        qblk = q[:, qi * block_q:(qi + 1) * block_q].permute(0, 2, 3, 1, 4)
        q_ids = qi * block_q + torch.arange(block_q, device=dev)
        m = torch.full((B, KV, G, block_q), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, block_q), device=dev)
        acc = torch.zeros((B, KV, G, block_q, D), device=dev)
        for j in range(S // block_kv):
            sl = slice(j * block_kv, (j + 1) * block_kv)
            kblk = k[:, sl].permute(0, 2, 1, 3)          # (B,KV,bkv,D)
            vblk = v[:, sl].permute(0, 2, 1, 3)
            k_ids = j * block_kv + torch.arange(block_kv, device=dev)
            s = torch.einsum("bkgqd,bkcd->bkgqc", qblk, kblk).float() * scale
            s = s.masked_fill(~(k_ids[None, :] <= q_ids[:, None]), NEG_INF)
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
              backend: str = "auto") -> torch.Tensor:
    """x (B, Sq, E); positions (B, Sq) int32 absolute positions.

    With ``cache`` (this layer's ``(k_pool, v_pool)``, each (N, ps, KV, D),
    written in place) and ``page_table`` (B, P) int32: the paged serving
    path. Without: causal attention over the whole sequence (training)."""
    B, Sq, E = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = cm.rope(_project(x, attn.wq), positions, cfg.rope_theta)
    q = q.view(B, Sq, KV, H // KV, D)            # grouped-query layout
    k = cm.rope(_project(x, attn.wk), positions, cfg.rope_theta)
    v = _project(x, attn.wv)

    if cache is None:
        if (Sq >= cfg.blockwise_threshold and Sq % cfg.attn_block_q == 0
                and Sq % cfg.attn_block_kv == 0):
            att = _attend_blockwise(q, k, v, block_q=cfg.attn_block_q,
                                    block_kv=cfg.attn_block_kv)
        else:
            att = _attend_masked(q, k, v, positions, positions)
        return _proj_out(cfg, attn, att)

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
            positions[:, 0].contiguous(), backend=backend)[:, None]
    else:
        att = pa.paged_attend_ref(q, k_pool, v_pool, page_table, positions)
    return _proj_out(cfg, attn, att)


def _proj_out(cfg: ModelConfig, attn: Attention, att: torch.Tensor
              ) -> torch.Tensor:
    """att (B, S, KV, G, D) grouped layout -> (B, S, E)."""
    B, S = att.shape[:2]
    H, D, E = attn.wo.shape
    return att.reshape(B, S, H * D) @ attn.wo.to(att.dtype).reshape(H * D, E)

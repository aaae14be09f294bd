"""GQA attention over the paged KV pool (the serving path).

Counterpart of the paged branch of ``repro.models.attention.attention``:
project q/k/v, apply RoPE, scatter this step's K/V into the pool at
``(page, offset)`` — positions past the page table's reach go to the trash
page — and read back through the page table. One query position
(``Sq == 1``, decode) goes to the CUDA kernel; a prompt chunk
(``Sq > 1``) goes to the plain gather :func:`paged_attend_ref`, exactly as
the reference does. The pool is updated in place.
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


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, E) x (E, h, D) -> (B, S, h, D)."""
    E, h, D = w.shape
    return (x @ w.to(x.dtype).reshape(E, h * D)).view(*x.shape[:2], h, D)


def attention(cfg: ModelConfig, attn: Attention, x: torch.Tensor, *,
              positions: torch.Tensor,
              cache: Tuple[torch.Tensor, torch.Tensor],
              page_table: torch.Tensor,
              backend: str = "auto") -> torch.Tensor:
    """x (B, Sq, E); positions (B, Sq) int32 absolute positions; ``cache``
    this layer's ``(k_pool, v_pool)``, each (N, ps, KV, D), written in
    place; page_table (B, P) int32."""
    B, Sq, E = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = cm.rope(_project(x, attn.wq), positions, cfg.rope_theta)
    q = q.view(B, Sq, KV, H // KV, D)            # grouped-query layout
    k = cm.rope(_project(x, attn.wk), positions, cfg.rope_theta)
    v = _project(x, attn.wv)

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

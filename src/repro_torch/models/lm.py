"""The decoder-only LM for ``block_unit=("attn",)``: serving and training
entry points.

Counterpart of ``repro.models.lm`` for the port's serving and training
paths. The reference scans one stacked layer unit with ``lax.scan``; here
:func:`backbone` is a Python loop over an ``nn.ModuleList``. Serving: the
KV caches are one pair of ``(n_layers, N, ps, KV, D)`` page pools
(:class:`repro_torch.serve.cache.PagedCachePool`), updated in place, so the
entry points return no caches. Training: :func:`loss_fn` runs the stack
without caches; with ``cfg.remat`` each layer is checkpointed
(``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint`` of the scan body) and runs again in the backward pass.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlpm


class Layer(nn.Module):
    """One ``attn`` block: norm → attention → residual, norm → MLP →
    residual."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None,
                 site_specs: cm.SiteSpecs = None):
        super().__init__()
        E = cfg.d_model
        self.norm1 = nn.Parameter(torch.ones(E, dtype=cfg.pdtype()))
        self.attn = attn.Attention(cfg, generator=generator)
        self.norm2 = nn.Parameter(torch.ones(E, dtype=cfg.pdtype()))
        self.ffn = mlpm.MLP(cfg, generator=generator, site_specs=site_specs)


class LM(nn.Module):
    """Parameters named after the reference's param tree (``embed.table``,
    ``layers.<i>.attn.wq``, ``layers.<i>.ffn.up.b_in``, ``head.core``, ...),
    initialised from ``generator``."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None,
                 site_specs: cm.SiteSpecs = None):
        super().__init__()
        if tuple(cfg.block_unit) != ("attn",):
            raise ValueError(f"{cfg.name}: the port serves block_unit "
                             f"('attn',) only, got {cfg.block_unit}")
        self.cfg = cfg
        self.embed = cm.Embed(cfg, generator=generator)
        self.layers = nn.ModuleList(
            Layer(cfg, generator=generator, site_specs=site_specs)
            for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(
            torch.ones(cfg.d_model, dtype=cfg.pdtype()))
        self.head = cm.head_module(cfg, generator=generator,
                                   site_specs=site_specs)


def layer_apply(cfg: ModelConfig, layer: Layer, x: torch.Tensor, *,
                positions: torch.Tensor,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                page_table: Optional[torch.Tensor] = None,
                backend: str = "auto") -> torch.Tensor:
    """One layer; without ``cache`` the attention runs over the whole
    sequence (training)."""
    h = cm.rmsnorm(x, layer.norm1, cfg.norm_eps)
    x = x + attn.attention(cfg, layer.attn, h, positions=positions,
                           cache=cache, page_table=page_table,
                           backend=backend)
    h = cm.rmsnorm(x, layer.norm2, cfg.norm_eps)
    return x + mlpm.mlp_apply(cfg, layer.ffn, h, backend)


def backbone(model: LM, x: torch.Tensor, *, positions: torch.Tensor,
             caches: Optional[Dict[str, torch.Tensor]] = None,
             page_table: Optional[torch.Tensor] = None,
             backend: str = "auto") -> torch.Tensor:
    """Run the layer stack. Serving: ``caches`` is ``{"k", "v"}`` of
    ``(n_layers, N, ps, KV, D)`` pools, written in place. Training
    (``caches=None``): with ``cfg.remat`` and gradients on, each layer is
    checkpointed and recomputed in the backward pass."""
    cfg = model.cfg
    remat = caches is None and cfg.remat and torch.is_grad_enabled()
    for i, layer in enumerate(model.layers):
        cache = None if caches is None else (caches["k"][i], caches["v"][i])
        if remat:
            x = checkpoint(layer_apply, cfg, layer, x, positions=positions,
                           backend=backend, use_reentrant=False)
        else:
            x = layer_apply(cfg, layer, x, positions=positions, cache=cache,
                            page_table=page_table, backend=backend)
    return x


def loss_fn(model: LM, batch: Mapping[str, torch.Tensor],
            backend: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """Training loss, the mean next-token CE over ``batch`` ``tokens``
    (B, S), ``targets`` (B, S) and optional ``mask`` (B, S), plus metrics
    ``{"ce", "aux"}`` (``aux`` is 0: the port has no MoE)."""
    cfg = model.cfg
    tokens = batch["tokens"]
    x = cm.embed(cfg, model.embed, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    x = backbone(model, x, positions=positions, backend=backend)
    x = cm.rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = cm.head_apply(cfg, model.head, x, backend)
    mask = batch.get("mask")
    ce = cm.cross_entropy(logits[:, :-1], batch["targets"][:, 1:],
                          None if mask is None else mask[:, 1:])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return ce + aux, {"ce": ce, "aux": aux}


def decode_step(model: LM, token: torch.Tensor,
                caches: Dict[str, torch.Tensor], cur_pos: torch.Tensor,
                page_table: torch.Tensor, backend: str = "auto"
                ) -> torch.Tensor:
    """One decode step: ``token`` (B,) at absolute positions ``cur_pos``
    (B,) (or a scalar for the whole batch). Returns logits (B, V)."""
    cfg = model.cfg
    x = cm.embed(cfg, model.embed, token[:, None])
    B = x.shape[0]
    cur_pos = torch.as_tensor(cur_pos, dtype=torch.int32, device=x.device)
    positions = cur_pos.expand(B)[:, None] if cur_pos.ndim == 0 \
        else cur_pos[:, None]
    x = backbone(model, x, positions=positions.contiguous(), caches=caches,
                 page_table=page_table, backend=backend)
    x = cm.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return cm.head_apply(cfg, model.head, x, backend)[:, 0]


def prefill_chunk(model: LM, tokens: torch.Tensor,
                  caches: Dict[str, torch.Tensor], start_pos: torch.Tensor,
                  last_idx: torch.Tensor, page_table: torch.Tensor,
                  backend: str = "auto"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fixed-size prompt chunk through the paged decode path.

    ``tokens`` (B, C) are C consecutive prompt tokens per row, right-padded
    on a prompt's final chunk; ``start_pos`` (B,) the absolute position of
    each row's first chunk token; ``last_idx`` (B,) the within-chunk index
    of the last real token, whose logits are the readout. Causality keeps
    each real position's KV independent of the pad tail; pad writes land in
    reserved pages past the prompt or on the trash page. Returns
    ``(logits (B, V), h_last (B, E))`` with ``h_last`` the pre-final-norm
    state at ``last_idx``.
    """
    cfg = model.cfg
    x = cm.embed(cfg, model.embed, tokens)
    B, C, _ = x.shape
    start_pos = torch.as_tensor(start_pos, dtype=torch.int32,
                                device=x.device)
    positions = start_pos[:, None] + torch.arange(
        C, dtype=torch.int32, device=x.device)[None, :]
    x = backbone(model, x, positions=positions, caches=caches,
                 page_table=page_table, backend=backend)
    rows = torch.arange(B, device=x.device)
    x_last = x[rows, torch.as_tensor(last_idx, device=x.device).long()]
    h = cm.rmsnorm(x_last[:, None], model.final_norm, cfg.norm_eps)
    logits = cm.head_apply(cfg, model.head, h, backend)
    return logits[:, 0], x_last

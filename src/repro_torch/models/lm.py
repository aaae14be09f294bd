"""The decoder-only LM for units of ``attn``, ``local``, ``global``,
``moe``, ``rec``, ``mlstm`` and ``slstm`` blocks, with a tail: serving and
training entry points.

Counterpart of ``repro.models.lm`` for the port's serving and training
paths. The reference scans a stacked layer unit ``unit_repeats`` times with
``lax.scan``, then runs the ``tail_layers`` unrolled; here the layers are
one ``nn.ModuleList`` in that order (:func:`layer_types`) and
:func:`backbone` is a Python loop over it, summing each block's aux loss as
the reference's scan carry does. ``global`` is ``attn`` with window 0 and
``local`` is ``attn`` with ``cfg.sliding_window``, as in the reference;
``moe`` swaps the MLP for :class:`repro_torch.models.moe.MoE`; ``rec`` is
the Griffin recurrent block and an MLP (:mod:`repro_torch.models.rglru`),
``mlstm`` and ``slstm`` the xLSTM blocks alone (:mod:`repro_torch.models.
xlstm`).

Serving: the caches are one flat dict of stacked tensors, updated in place
(:mod:`repro_torch.serve.cache`): ``"k"``/``"v"`` for the full-attention
layers (pages of the paged pool with a page table, one full row per slot
without), ``"ring_k"``/``"ring_v"`` for the ``local`` layers' rings, and
per-type state stacks for the recurrent blocks (``"rec_h"``,
``"rec_conv"``, ``"mlstm_C"``, ..., ``"slstm_h"``: :data:`STATE_FIELDS`);
:func:`cache_index` names each layer's entry and :func:`layer_cache`
takes its views. The entry points return no caches and drop the aux
loss. Training: :func:`loss_fn` runs the stack without caches; with
``cfg.remat`` each layer is checkpointed (``torch.utils.checkpoint``, the
counterpart of the reference's ``jax.checkpoint`` of the scan body) and
runs again in the backward pass.

The rest of the zoo is refused with a ``ValueError`` naming the ROADMAP
sub-item that brings it (:func:`unported_reason`).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.context import ContextLike
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlpm
from repro_torch.models import moe as moem
from repro_torch.models import rglru as rgm
from repro_torch.models import xlstm as xm

#: the ROADMAP sub-item (queue 1, item 5) that brings each unported piece
_SUB_ITEMS = {
    "xdec": "5d (frontends and the encoder)",
    "enc": "5d (frontends and the encoder)",
}


def unported_reason(cfg: ModelConfig) -> Optional[str]:
    """``None`` when the port builds, serves and trains ``cfg``; else why
    not, naming the ROADMAP sub-item (queue 1, item 5d) that brings it."""
    def refuse(what: str, item: str) -> str:
        return (f"{cfg.name}: {what} is not ported yet (ROADMAP queue 1, "
                f"item {item})")

    for t in tuple(cfg.block_unit) + tuple(cfg.tail_layers):
        if t in _SUB_ITEMS:
            return refuse(f"block type {t!r}", _SUB_ITEMS[t])
    if cfg.frontend or cfg.n_enc_layers:
        return refuse(f"the {cfg.frontend or 'encoder'} frontend",
                      _SUB_ITEMS["enc"])
    return None


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` with :func:`unported_reason` when ``cfg`` is
    not ported."""
    reason = unported_reason(cfg)
    if reason is not None:
        raise ValueError(reason)


def layer_types(cfg: ModelConfig) -> Tuple[str, ...]:
    """Each layer's block type in the reference's order: the unit
    ``unit_repeats`` times, then the tail."""
    return (tuple(cfg.block_unit) * cfg.unit_repeats
            + tuple(cfg.tail_layers))


#: the serving state of each recurrent block type, one stack per field
#: (``"rec_h"``, ``"rec_conv"``, ...), in the reference's cache layout
STATE_FIELDS = {"rec": ("h", "conv"), "mlstm": ("C", "n", "m", "conv"),
                "slstm": ("c", "n", "m", "h")}

#: the cache-entry prefix of each block type besides full attention's ""
_PREFIXES = {"local": "ring_", **{t: t + "_" for t in STATE_FIELDS}}

LayerCache = Union[Tuple[torch.Tensor, torch.Tensor],
                   Dict[str, torch.Tensor]]


def cache_index(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Per layer, the prefix of its serving cache entries (``""`` for
    ``"k"``/``"v"``, ``"ring_"`` for a ``local`` layer's ring, ``"rec_"``,
    ``"mlstm_"`` or ``"slstm_"`` for a recurrent block's state) and its
    index in those stacks."""
    seen: Dict[str, int] = {}
    out = []
    for t in layer_types(cfg):
        pre = _PREFIXES.get(t, "")
        out.append((pre, seen.get(pre, 0)))
        seen[pre] = seen.get(pre, 0) + 1
    return out


def layer_cache(cfg: ModelConfig, caches: Mapping[str, torch.Tensor],
                layer: int, index: Optional[List[Tuple[str, int]]] = None
                ) -> LayerCache:
    """Layer ``layer``'s views into the stacked ``caches``: ``(k, v)`` for
    an attention block, ``{field: tensor}`` for a recurrent one; writing
    them writes the pool. ``index`` is :func:`cache_index` (computed when
    not given)."""
    pre, j = (index or cache_index(cfg))[layer]
    btype = layer_types(cfg)[layer]
    if btype in STATE_FIELDS:
        return {f: caches[pre + f][j] for f in STATE_FIELDS[btype]}
    return caches[pre + "k"][j], caches[pre + "v"][j]


class Layer(nn.Module):
    """One block, with the reference's per-type parameters: an
    ``attn``/``local``/``global``/``moe`` block is norm → attention →
    residual, norm → MLP or MoE → residual; ``rec`` the same with the
    recurrent block in attention's place; ``mlstm`` and ``slstm`` are norm
    → block → residual."""

    def __init__(self, cfg: ModelConfig, btype: str, *,
                 generator: Optional[torch.Generator] = None,
                 site_specs: cm.SiteSpecs = None):
        super().__init__()
        E = cfg.d_model
        self.btype = btype

        def norm() -> nn.Parameter:
            return nn.Parameter(torch.ones(E, dtype=cfg.pdtype()))

        self.norm1 = norm()
        if btype == "mlstm":
            self.mlstm = xm.MLSTM(cfg, generator=generator)
            return
        if btype == "slstm":
            self.slstm = xm.SLSTM(cfg, generator=generator)
            return
        if btype == "rec":
            self.rec = rgm.RGLRU(cfg, generator=generator)
        else:
            self.attn = attn.Attention(cfg, generator=generator)
        self.norm2 = norm()
        self.ffn = (moem.MoE(cfg, generator=generator) if btype == "moe"
                    else mlpm.MLP(cfg, generator=generator,
                                  site_specs=site_specs))


class LM(nn.Module):
    """Parameters named after the reference's param tree (``embed.table``,
    ``layers.<i>.attn.wq``, ``layers.<i>.ffn.up.b_in``,
    ``layers.<i>.ffn.router``, ``head.core``, ...), initialised from
    ``generator``. A ``tie_embeddings`` config has no head parameters
    (:class:`repro_torch.models.common.TiedHead`)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None,
                 site_specs: cm.SiteSpecs = None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.embed = cm.Embed(cfg, generator=generator)
        self.layers = nn.ModuleList(
            Layer(cfg, t, generator=generator, site_specs=site_specs)
            for t in layer_types(cfg))
        self.final_norm = nn.Parameter(
            torch.ones(cfg.d_model, dtype=cfg.pdtype()))
        self.head = cm.head_module(cfg, self.embed, generator=generator,
                                   site_specs=site_specs)


#: each recurrent block type's block function; its module is the layer's
#: attribute of the type's name
_RECURRENT = {"rec": rgm.rglru_block, "mlstm": xm.mlstm_block,
              "slstm": xm.slstm_block}


def layer_apply(cfg: ModelConfig, layer: Layer, x: torch.Tensor, *,
                positions: torch.Tensor, cache: Optional[LayerCache] = None,
                page_table: Optional[torch.Tensor] = None,
                prefill: bool = False, context: ContextLike = None
                ) -> Tuple[torch.Tensor, moem.AuxLoss]:
    """One layer; returns ``(x, aux)`` with ``aux`` the MoE's aux loss,
    0.0 for other blocks and when serving (``cache`` given: the entry
    points drop it). ``cache`` is the layer's :func:`layer_cache`. Without
    it the block runs over the whole sequence (training); ``prefill``
    fills it from the whole prompt; else one decode position updates it,
    all in place (:func:`repro_torch.models.attention.attention`,
    :func:`repro_torch.models.rglru.rglru_block`, :func:`repro_torch.
    models.xlstm.mlstm_block`, :func:`repro_torch.models.xlstm.
    slstm_block`)."""
    h = cm.rmsnorm(x, layer.norm1, cfg.norm_eps)
    if layer.btype in _RECURRENT:
        mode = ("train" if cache is None
                else "prefill" if prefill else "decode")
        x = x + _RECURRENT[layer.btype](cfg, getattr(layer, layer.btype), h,
                                        mode=mode, cache=cache)
        if layer.btype != "rec":
            return x, 0.0
    else:
        window = cfg.sliding_window if layer.btype == "local" else 0
        x = x + attn.attention(cfg, layer.attn, h, positions=positions,
                               cache=cache, page_table=page_table,
                               window=window, prefill=prefill,
                               context=context)
    h = cm.rmsnorm(x, layer.norm2, cfg.norm_eps)
    if layer.btype == "moe":
        f, aux = moem.moe_apply(cfg, layer.ffn, h, with_aux=cache is None)
        return x + f, aux
    return x + mlpm.mlp_apply(cfg, layer.ffn, h, context), 0.0


def backbone(model: LM, x: torch.Tensor, *, positions: torch.Tensor,
             caches: Optional[Dict[str, torch.Tensor]] = None,
             page_table: Optional[torch.Tensor] = None,
             prefill: bool = False, context: ContextLike = None
             ) -> Tuple[torch.Tensor, moem.AuxLoss]:
    """Run the layer stack; returns ``(x, aux)``, the blocks' aux losses
    summed in layer order (0.0 without MoE blocks, and when serving).
    Serving: ``caches`` holds the stacked ``"k"``/``"v"``,
    ``"ring_k"``/``"ring_v"`` and recurrent state caches (:func:`
    cache_index`), written in place. Training (``caches=None``): with
    ``cfg.remat`` and gradients on, each layer is checkpointed and
    recomputed in the backward pass."""
    cfg = model.cfg
    remat = caches is None and cfg.remat and torch.is_grad_enabled()
    index = cache_index(cfg)
    aux = 0.0
    for i, layer in enumerate(model.layers):
        cache = None
        if caches is not None:
            cache = layer_cache(cfg, caches, i, index)
        if remat:
            x, a = checkpoint(layer_apply, cfg, layer, x,
                              positions=positions, context=context,
                              use_reentrant=False)
        else:
            x, a = layer_apply(cfg, layer, x, positions=positions,
                               cache=cache, page_table=page_table,
                               prefill=prefill, context=context)
        aux = aux + a
    return x, aux


def loss_fn(model: LM, batch: Mapping[str, torch.Tensor],
            context: ContextLike = None) -> Tuple[torch.Tensor, Dict]:
    """Training loss, the mean next-token CE over ``batch`` ``tokens``
    (B, S), ``targets`` (B, S) and optional ``mask`` (B, S), plus metrics
    ``{"ce", "aux"}``; the loss is ``ce + aux``, ``aux`` the MoE blocks'
    summed aux losses (0 without MoE)."""
    cfg = model.cfg
    tokens = batch["tokens"]
    x = cm.embed(cfg, model.embed, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    x, aux = backbone(model, x, positions=positions, context=context)
    x = cm.rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = cm.head_apply(cfg, model.head, x, context)
    mask = batch.get("mask")
    ce = cm.cross_entropy(logits[:, :-1], batch["targets"][:, 1:],
                          None if mask is None else mask[:, 1:])
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce + aux, {"ce": ce, "aux": aux}


def prefill_at(model: LM, tokens: torch.Tensor,
               caches: Dict[str, torch.Tensor], last_pos: torch.Tensor,
               context: ContextLike = None) -> torch.Tensor:
    """Whole-prompt prefill: ``tokens`` (B, S) right-padded prompts at
    positions ``0..S-1``, ``last_pos`` (B,) each prompt's last real token,
    whose logits (B, V) are returned. Fills the dense-layout ``caches``
    (full rows of length >= S, rings and recurrent state, :func:`
    repro_torch.serve.cache.init_caches`) in place. Causality keeps the pad
    tail inert for every real position, so the caches serve decode as they
    are; not for rings, where pads would push real positions out, nor for
    recurrent state, which would fold the pads in: the engine prefills
    archs with ``local`` or recurrent blocks at their exact prompt
    lengths."""
    cfg = model.cfg
    x = cm.embed(cfg, model.embed, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    x, _ = backbone(model, x, positions=positions, caches=caches,
                    prefill=True, context=context)
    rows = torch.arange(B, device=x.device)
    x_last = x[rows, torch.as_tensor(last_pos, device=x.device).long()]
    h = cm.rmsnorm(x_last[:, None], model.final_norm, cfg.norm_eps)
    return cm.head_apply(cfg, model.head, h, context)[:, 0]


def prefill(model: LM, tokens: torch.Tensor,
            caches: Dict[str, torch.Tensor], context: ContextLike = None
            ) -> torch.Tensor:
    """:func:`prefill_at` read at the last position of ``tokens`` (B, S)."""
    last = torch.full((tokens.shape[0],), tokens.shape[1] - 1,
                      dtype=torch.int32, device=tokens.device)
    return prefill_at(model, tokens, caches, last, context)


def decode_step(model: LM, token: torch.Tensor,
                caches: Dict[str, torch.Tensor], cur_pos: torch.Tensor,
                page_table: Optional[torch.Tensor] = None,
                context: ContextLike = None) -> torch.Tensor:
    """One decode step: ``token`` (B,) at absolute positions ``cur_pos``
    (B,) (or a scalar for the whole batch), through the paged pool with
    ``page_table`` or the dense one without. Returns logits (B, V)."""
    cfg = model.cfg
    x = cm.embed(cfg, model.embed, token[:, None])
    B = x.shape[0]
    cur_pos = torch.as_tensor(cur_pos, dtype=torch.int32, device=x.device)
    positions = cur_pos.expand(B)[:, None] if cur_pos.ndim == 0 \
        else cur_pos[:, None]
    x, _ = backbone(model, x, positions=positions.contiguous(),
                    caches=caches, page_table=page_table, context=context)
    x = cm.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return cm.head_apply(cfg, model.head, x, context)[:, 0]


def prefill_chunk(model: LM, tokens: torch.Tensor,
                  caches: Dict[str, torch.Tensor], start_pos: torch.Tensor,
                  last_idx: torch.Tensor, page_table: torch.Tensor,
                  context: ContextLike = None
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
    x, _ = backbone(model, x, positions=positions, caches=caches,
                    page_table=page_table, context=context)
    rows = torch.arange(B, device=x.device)
    x_last = x[rows, torch.as_tensor(last_idx, device=x.device).long()]
    h = cm.rmsnorm(x_last[:, None], model.final_norm, cfg.norm_eps)
    logits = cm.head_apply(cfg, model.head, h, context)
    return logits[:, 0], x_last


def verify_chunk(model: LM, tokens: torch.Tensor,
                 caches: Dict[str, torch.Tensor], cur_pos: torch.Tensor,
                 page_table: torch.Tensor, context: ContextLike = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-position verify forward for speculative decoding.

    ``tokens`` (B, K) are each row's last committed token followed by K-1
    draft tokens, at absolute positions ``cur_pos .. cur_pos+K-1``. One
    pass through the chunked-prefill path (the plain gather
    :func:`~repro_torch.kernels.paged_attention.paged_attend_ref` for
    ``K > 1``, as the reference) gives the logits at all K positions.
    Returns ``(logits (B, K, V), x (B, K, E))`` with ``x`` the
    pre-final-norm states: position ``j`` is the draft anchor when the
    commit stops after input ``j``. Rejected positions' KV writes stay in
    place past the committed ``cur_pos``, masked out by validity until the
    next pass overwrites them.
    """
    cfg = model.cfg
    x = cm.embed(cfg, model.embed, tokens)
    B, K, _ = x.shape
    cur_pos = torch.as_tensor(cur_pos, dtype=torch.int32, device=x.device)
    positions = cur_pos[:, None] + torch.arange(
        K, dtype=torch.int32, device=x.device)[None, :]
    x, _ = backbone(model, x, positions=positions, caches=caches,
                    page_table=page_table, context=context)
    h = cm.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return cm.head_apply(cfg, model.head, h, context), x

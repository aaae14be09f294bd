"""The LM for units of ``attn``, ``local``, ``global``, ``moe``, ``rec``,
``mlstm``, ``slstm`` and ``xdec`` blocks, with a tail, an ``enc`` encoder
stack and the frontends' projection: serving and training entry points.

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
xlstm`); ``xdec`` is self-attention, then attention across to the
encoder's output (:func:`repro_torch.models.attention.cross_attention`),
then the MLP.

The frontends are the reference's stubs: their inputs are precomputed
embeddings. A ``vision`` config (internvl2-1b) projects each request's
``frontend_embeds`` (B, frontend_tokens, E) through ``frontend_proj`` and
prepends them to the text (:func:`embed_inputs`); the loss reads the
logits after them and a prefill reads out at ``last_pos + n_front``. An
encoder config (seamless-m4t-medium) runs ``frames`` (B, S_enc, E)
through ``n_enc_layers`` bidirectional ``enc`` blocks and ``enc_norm``
(:func:`run_encoder`, no checkpointing, as the reference's scan has
none), whose output the ``xdec`` blocks attend to. Every config with a
``frontend`` has a ``frontend_proj``, as the reference's tree does; an
``audio`` one never uses it.

Serving: the caches are one flat dict of stacked tensors, updated in place
(:mod:`repro_torch.serve.cache`): ``"k"``/``"v"`` for the full-attention
layers, ``xdec``'s self-attention among them (pages of the paged pool with
a page table, one full row per slot without), ``"ring_k"``/``"ring_v"``
for the ``local`` layers' rings, ``"cross_k"``/``"cross_v"`` for the
``xdec`` layers' encoder rows, and per-type state stacks for the recurrent
blocks (``"rec_h"``, ``"rec_conv"``, ``"mlstm_C"``, ..., ``"slstm_h"``:
:data:`STATE_FIELDS`); :func:`cache_index` names each layer's entry and
:func:`layer_cache` takes its views. The entry points return no caches
and drop the aux loss. Training: :func:`loss_fn` runs the stack without
caches; with ``cfg.remat`` each decoder layer is checkpointed
(``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint`` of the scan body) and runs again in the backward pass,
under the ambient sharding context of its forward
(:func:`~repro_torch.runtime.sharding.carry_ctx`: on a card the autograd
engine recomputes it on a thread of its own).

A block type the reference does not know raises ``ValueError``, as the
reference's ``layer_specs`` does.
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
from repro_torch.nn.linear import scaled_normal
from repro_torch.runtime import loops
from repro_torch.runtime.sharding import carry_ctx

#: the block types of the reference's ``layer_specs``
BLOCK_TYPES = ("attn", "local", "global", "moe", "rec", "mlstm", "slstm",
               "xdec", "enc")

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

KVPair = Tuple[torch.Tensor, torch.Tensor]
LayerCache = Union[KVPair, Tuple[KVPair, KVPair], Dict[str, torch.Tensor]]


def cache_index(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Per layer, the prefix of its serving cache entries (``""`` for
    ``"k"``/``"v"``, an ``xdec`` layer's self-attention included,
    ``"ring_"`` for a ``local`` layer's ring, ``"rec_"``, ``"mlstm_"`` or
    ``"slstm_"`` for a recurrent block's state) and its index in those
    stacks. An ``xdec`` layer's cross rows sit at its index among the
    ``xdec`` layers in ``"cross_k"``/``"cross_v"``."""
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
    an attention block, ``((k, v), (cross_k, cross_v))`` for an ``xdec``
    one, ``{field: tensor}`` for a recurrent one; writing them writes the
    pool. ``index`` is :func:`cache_index` (computed when not given)."""
    pre, j = (index or cache_index(cfg))[layer]
    types = layer_types(cfg)
    btype = types[layer]
    if btype in STATE_FIELDS:
        return {f: caches[pre + f][j] for f in STATE_FIELDS[btype]}
    kv = caches[pre + "k"][j], caches[pre + "v"][j]
    if btype == "xdec":
        jx = types[:layer].count("xdec")
        return kv, (caches["cross_k"][jx], caches["cross_v"][jx])
    return kv


class Layer(nn.Module):
    """One block, with the reference's per-type parameters: an
    ``attn``/``local``/``global``/``moe``/``enc`` block is norm → attention
    → residual, norm → MLP or MoE → residual; ``rec`` the same with the
    recurrent block in attention's place; ``xdec`` adds norm (``norm_x``)
    → cross-attention (``xattn``) → residual before the MLP; ``mlstm`` and
    ``slstm`` are norm → block → residual."""

    def __init__(self, cfg: ModelConfig, btype: str, *,
                 generator: Optional[torch.Generator] = None,
                 site_specs: cm.SiteSpecs = None):
        super().__init__()
        if btype not in BLOCK_TYPES:
            raise ValueError(f"unknown block type {btype!r}")
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
        if btype == "xdec":
            self.norm_x = norm()
            self.xattn = attn.Attention(cfg, generator=generator)
        self.norm2 = norm()
        self.ffn = (moem.MoE(cfg, generator=generator) if btype == "moe"
                    else mlpm.MLP(cfg, generator=generator,
                                  site_specs=site_specs))


class LM(nn.Module):
    """Parameters named after the reference's param tree (``embed.table``,
    ``layers.<i>.attn.wq``, ``layers.<i>.ffn.up.b_in``,
    ``layers.<i>.ffn.router``, ``head.core``, ...; the encoder's
    ``enc_layers.<i>.*`` for its stacked ``enc_unit[0]``, ``enc_norm``,
    ``frontend_proj`` (E, E)), initialised from ``generator``. A
    ``tie_embeddings`` config has no head parameters
    (:class:`repro_torch.models.common.TiedHead`)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None,
                 site_specs: cm.SiteSpecs = None):
        super().__init__()
        self.cfg = cfg
        E = cfg.d_model
        self.embed = cm.Embed(cfg, generator=generator)
        if cfg.frontend:
            self.frontend_proj = nn.Parameter(
                scaled_normal(generator, (E, E), E).to(cfg.pdtype()))
        if cfg.n_enc_layers:
            self.enc_layers = nn.ModuleList(
                Layer(cfg, "enc", generator=generator, site_specs=site_specs)
                for _ in range(cfg.n_enc_layers))
            self.enc_norm = nn.Parameter(torch.ones(E, dtype=cfg.pdtype()))
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
                prefill: bool = False, context: ContextLike = None,
                enc_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, moem.AuxLoss]:
    """One layer; returns ``(x, aux)`` with ``aux`` the MoE's aux loss,
    0.0 for other blocks and when serving (``cache`` given: the entry
    points drop it). ``cache`` is the layer's :func:`layer_cache`. Without
    it the block runs over the whole sequence (training, and the encoder);
    ``prefill`` fills it from the whole prompt; else one decode position
    updates it, all in place (:func:`repro_torch.models.attention.
    attention`, :func:`repro_torch.models.attention.cross_attention`,
    :func:`repro_torch.models.rglru.rglru_block`, :func:`repro_torch.
    models.xlstm.mlstm_block`, :func:`repro_torch.models.xlstm.
    slstm_block`). ``enc_out`` is the encoder's output, which an ``xdec``
    block attends to in training and at prefill."""
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
        self_cache, cross_cache = (cache if layer.btype == "xdec"
                                   and cache is not None else (cache, None))
        x = x + attn.attention(cfg, layer.attn, h, positions=positions,
                               cache=self_cache, page_table=page_table,
                               window=window, prefill=prefill,
                               causal=layer.btype != "enc", context=context)
        if layer.btype == "xdec":
            h = cm.rmsnorm(x, layer.norm_x, cfg.norm_eps)
            x = x + attn.cross_attention(cfg, layer.xattn, h,
                                         enc_out=enc_out, cache=cross_cache,
                                         prefill=prefill)
    h = cm.rmsnorm(x, layer.norm2, cfg.norm_eps)
    if layer.btype == "moe":
        f, aux = moem.moe_apply(cfg, layer.ffn, h, with_aux=cache is None)
        return x + f, aux
    return x + mlpm.mlp_apply(cfg, layer.ffn, h, context), 0.0


def backbone(model: LM, x: torch.Tensor, *, positions: torch.Tensor,
             caches: Optional[Dict[str, torch.Tensor]] = None,
             page_table: Optional[torch.Tensor] = None,
             prefill: bool = False, context: ContextLike = None,
             enc_out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, moem.AuxLoss]:
    """Run the layer stack; returns ``(x, aux)``, the blocks' aux losses
    summed in layer order (0.0 without MoE blocks, and when serving).
    Serving: ``caches`` holds the stacked ``"k"``/``"v"``,
    ``"ring_k"``/``"ring_v"``, ``"cross_k"``/``"cross_v"`` and recurrent
    state caches (:func:`cache_index`), written in place. Training
    (``caches=None``): with ``cfg.remat`` and gradients on, each layer is
    checkpointed and recomputed in the backward pass. ``enc_out`` is the
    encoder's output (:func:`run_encoder`) for the ``xdec`` blocks."""
    cfg = model.cfg
    remat = caches is None and cfg.remat and torch.is_grad_enabled()
    index = cache_index(cfg)
    aux = 0.0
    for i in loops.layers(len(model.layers), len(cfg.block_unit),
                          cfg.unit_repeats):
        layer = model.layers[i]
        cache = None
        if caches is not None:
            cache = layer_cache(cfg, caches, i, index)
        if remat:
            x, a = checkpoint(carry_ctx(layer_apply), cfg, layer, x,
                              positions=positions, context=context,
                              enc_out=enc_out, use_reentrant=False)
        else:
            x, a = layer_apply(cfg, layer, x, positions=positions,
                               cache=cache, page_table=page_table,
                               prefill=prefill, context=context,
                               enc_out=enc_out)
        aux = aux + a
    return x, aux


def _positions(x: torch.Tensor) -> torch.Tensor:
    """Positions ``0..S-1`` (B, S) int32 of a whole sequence x (B, S, E)."""
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)


def run_encoder(model: LM, frames: torch.Tensor,
                context: ContextLike = None) -> torch.Tensor:
    """The bidirectional encoder over precomputed frame embeddings (the
    reference's stub frontend): ``frames`` (B, S_enc, E) in the compute
    dtype through every ``enc`` layer, then ``enc_norm``. No layer is
    checkpointed, as the reference's scan is not."""
    cfg = model.cfg
    x = frames.to(cfg.cdtype())
    positions = _positions(x)
    for layer in model.enc_layers:
        x, _ = layer_apply(cfg, layer, x, positions=positions,
                           context=context)
    return cm.rmsnorm(x, model.enc_norm, cfg.norm_eps)


def embed_inputs(model: LM, tokens: torch.Tensor,
                 frontend_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The token embedding (B, S, E); a ``vision`` config prepends
    ``frontend_embeds`` (B, n_front, E) projected by ``frontend_proj``."""
    cfg = model.cfg
    x = cm.embed(cfg, model.embed, tokens)
    if cfg.frontend == "vision" and frontend_embeds is not None:
        fe = frontend_embeds.to(x.dtype) @ model.frontend_proj.to(x.dtype)
        x = torch.cat([fe, x], dim=1)
    return x


def _encode(model: LM, frames: Optional[torch.Tensor],
            context: ContextLike) -> Optional[torch.Tensor]:
    """The encoder's output for an encoder config (``frames`` required),
    ``None`` for any other."""
    if not model.cfg.n_enc_layers:
        return None
    if frames is None:
        raise ValueError(f"{model.cfg.name}: the encoder needs frames "
                         f"(B, S_enc, {model.cfg.d_model})")
    return run_encoder(model, frames, context)


def loss_fn(model: LM, batch: Mapping[str, torch.Tensor],
            context: ContextLike = None) -> Tuple[torch.Tensor, Dict]:
    """Training loss, the mean next-token CE over ``batch`` ``tokens``
    (B, S), ``targets`` (B, S) and optional ``mask`` (B, S), plus metrics
    ``{"ce", "aux"}``; the loss is ``ce + aux``, ``aux`` the MoE blocks'
    summed aux losses (0 without MoE). A ``vision`` config's batch may
    carry ``frontend_embeds`` (B, n_front, E), prepended, the logits read
    after them; an encoder config's carries ``frames`` (B, S_enc, E)."""
    cfg = model.cfg
    tokens = batch["tokens"]
    x = embed_inputs(model, tokens, batch.get("frontend_embeds"))
    enc_out = _encode(model, batch.get("frames"), context)
    x, aux = backbone(model, x, positions=_positions(x), context=context,
                      enc_out=enc_out)
    x = cm.rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = cm.head_apply(cfg, model.head, x, context)
    logits = logits[:, x.shape[1] - tokens.shape[1]:]     # after the prefix
    mask = batch.get("mask")
    ce = cm.cross_entropy(logits[:, :-1], batch["targets"][:, 1:],
                          None if mask is None else mask[:, 1:])
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce + aux, {"ce": ce, "aux": aux}


def prefill_at(model: LM, tokens: torch.Tensor,
               caches: Dict[str, torch.Tensor], last_pos: torch.Tensor,
               context: ContextLike = None, *,
               frontend_embeds: Optional[torch.Tensor] = None,
               frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whole-prompt prefill: ``tokens`` (B, S) right-padded prompts,
    ``last_pos`` (B,) each prompt's last real token, whose logits (B, V)
    are returned. A ``vision`` config's ``frontend_embeds`` (B, n_front, E)
    take positions ``0..n_front-1`` and the text follows, read out at
    ``last_pos + n_front``; an encoder config's ``frames`` (B, S_enc, E)
    run through the encoder, whose output the ``xdec`` layers project into
    their cross rows. Fills the dense-layout ``caches`` (full rows of
    length >= n_front + S, rings, cross rows and recurrent state,
    :func:`repro_torch.serve.cache.init_caches`) in place. Causality keeps
    the pad tail inert for every real position, so the caches serve decode
    as they are; not for rings, where pads would push real positions out,
    nor for recurrent state, which would fold the pads in: the engine
    prefills archs with ``local`` or recurrent blocks at their exact prompt
    lengths."""
    cfg = model.cfg
    x = embed_inputs(model, tokens, frontend_embeds)
    enc_out = _encode(model, frames, context)
    x, _ = backbone(model, x, positions=_positions(x), caches=caches,
                    prefill=True, context=context, enc_out=enc_out)
    n_front = x.shape[1] - tokens.shape[1]
    rows = torch.arange(x.shape[0], device=x.device)
    x_last = x[rows, torch.as_tensor(last_pos, device=x.device).long()
               + n_front]
    h = cm.rmsnorm(x_last[:, None], model.final_norm, cfg.norm_eps)
    return cm.head_apply(cfg, model.head, h, context)[:, 0]


def prefill(model: LM, tokens: torch.Tensor,
            caches: Dict[str, torch.Tensor], context: ContextLike = None,
            **extras: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`prefill_at` read at the last position of ``tokens`` (B, S);
    ``extras`` are its ``frontend_embeds`` and ``frames``."""
    last = torch.full((tokens.shape[0],), tokens.shape[1] - 1,
                      dtype=torch.int32, device=tokens.device)
    return prefill_at(model, tokens, caches, last, context, **extras)


def decode_step(model: LM, token: torch.Tensor,
                caches: Dict[str, torch.Tensor], cur_pos: torch.Tensor,
                page_table: Optional[torch.Tensor] = None,
                context: ContextLike = None) -> torch.Tensor:
    """One decode step: ``token`` (B,) at absolute positions ``cur_pos``
    (B,) (or a scalar for the whole batch), through the paged pool with
    ``page_table`` or the dense one without; a ``vision`` request's
    positions count its prefix, and an ``xdec`` layer reads its cross rows.
    Returns logits (B, V)."""
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

"""Serve steps: the pooled decode tick (paged or dense), the chunked-prefill
tick, the two halves of a speculative tick (draft, verify) over the
engine's slots, and the whole-prompt prefill of one request. Counterparts
of the serving step factories in ``repro.train.steps``.

Each pool-wide step is a function of fixed-shape tensors and the KV pool,
free of host synchronisation and data-dependent control flow, so that the
engine can capture it once per shape as a CUDA graph
(:mod:`repro_torch.serve.graphs`) and replay it. The whole-prompt prefill
has a shape per prompt length (an exact length for archs with rings), so
the engine runs it eagerly. Sampling is not part of
the steps: the engine samples from the replayed logits eagerly, with its
own ``torch.Generator``.

Every builder takes the engine's finalized execution context
(``context=``) and every kernel call of its step gets it explicitly: a
replayed graph runs no Python, so a step must never read an ambient
``use_execution`` block. A step's own ``context=``, where it has one, is
for holding the kernels against the plain versions on the same state.

Pages are shared physical state and the pool is written in place, so an
inactive lane writing through a stale table row would corrupt a page a
later owner still needs: every step redirects inactive rows of the page
table to the trash page before the model sees it.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.context import ContextLike
from repro_torch.kernels.paged_attention import TRASH_PAGE
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.serve import cache as cache_lib


def mask_table(page_table: torch.Tensor, active: torch.Tensor
               ) -> torch.Tensor:
    """``page_table`` with the rows of inactive slots sent to the trash
    page."""
    return torch.where(active[:, None], page_table,
                       torch.full_like(page_table, TRASH_PAGE))


def make_pool_decode_step(model: lm.LM, caches,
                          context: ContextLike = None) -> Callable:
    """``step(tokens, cur_pos, active, page_table=None) -> (logits,)`` over
    the whole slot pool: ``tokens (S,)`` each slot's previous token,
    ``cur_pos (S,)`` its write position, ``active (S,)`` bool; ``logits
    (S, V)``. The arguments are the pool's ``gather_args()``: the paged
    pool's ``page_table``, or none for the dense pool, where an inactive
    lane writes into its own rows, which admission rewrites whole. The
    step's ``context=`` (:mod:`repro_torch.kernels.context`) overrides the
    builder's, to hold the kernels against the plain versions on the same
    state."""
    def step(tokens, cur_pos, active, page_table=None, context=context):
        table = None if page_table is None else mask_table(page_table,
                                                           active)
        with torch.no_grad():
            return (lm.decode_step(model, tokens, caches, cur_pos, table,
                                   context=context),)
    return step


def make_bucket_prefill_step(model: lm.LM, max_len: int,
                             context: ContextLike = None) -> Callable:
    """``step(tokens, last_pos, **extras) -> (logits, sub)``: the
    whole-prompt prefill of the engine's bucketed admission. ``tokens (B,
    bucket)`` are right-padded prompts, ``last_pos (B,)`` each one's last
    real token, ``extras`` a request's ``frontend_embeds`` and ``frames``
    (:func:`repro_torch.models.lm.prefill_at`); ``sub`` is a fresh dense
    cache tree at the pool's length ``max_len`` (its prefix included,
    :func:`repro_torch.serve.cache.init_caches`), filled, for the pool's
    ``write_slot``."""
    def step(tokens, last_pos, **extras):
        with torch.no_grad():
            sub = cache_lib.init_caches(model.cfg, tokens.shape[0], max_len,
                                        tokens.device)
            return lm.prefill_at(model, tokens, sub, last_pos,
                                 context=context, **extras), sub
    return step


def make_chunk_prefill_step(model: lm.LM, caches,
                            context: ContextLike = None) -> Callable:
    """``step(tokens, start_pos, last_idx, active, page_table) -> (logits,
    h_last)``: one fixed-size prompt chunk per slot (zeros for slots with
    nothing to prefill this tick); ``h_last`` is the pre-final-norm state at
    ``last_idx``, the speculative draft's anchor."""
    def step(tokens, start_pos, last_idx, active, page_table):
        with torch.no_grad():
            return lm.prefill_chunk(model, tokens, caches, start_pos,
                                    last_idx, mask_table(page_table, active),
                                    context=context)
    return step


def make_draft_step(model: lm.LM, k: int,
                    context: ContextLike = None) -> Callable:
    """Draft proposer of draft-k-verify-1 speculative decoding.

    ``draft(anchor, last_token) -> (drafts (S, k),)``: from each slot's
    anchor, the pre-final-norm state at its last committed input position,
    propose ``k`` greedy continuations without the backbone. The draft
    state advances by embedding feedback alone (``g <- g + embed(token)``)
    and reads out through the model's own head, the butterfly sandwich on
    butterfly-compressed archs. Draft quality moves speed only: greedy
    verification commits the full model's own tokens."""
    if k < 1:
        raise ValueError(f"draft step needs k >= 1, got {k}")
    cfg = model.cfg

    def draft(anchor, last_token):
        with torch.no_grad():
            g = anchor.to(cfg.cdtype())
            tok = last_token
            out = []
            for _ in range(k):
                g = g + cm.embed(cfg, model.embed, tok[:, None])[:, 0]
                h = cm.rmsnorm(g[:, None], model.final_norm, cfg.norm_eps)
                logits = cm.head_apply(cfg, model.head, h, context)
                tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
                out.append(tok)
            return (torch.stack(out, dim=1),)
    return draft


def make_spec_decode_step(model: lm.LM, caches, k: int,
                          context: ContextLike = None) -> Callable:
    """One speculative verify tick over the slot pool.

    ``step(tokens, cur_pos, active, page_table) -> (targets, accepted,
    anchor, logits)`` with ``tokens (S, k+1)`` each slot's last committed
    token and its ``k`` drafts at positions ``cur_pos .. cur_pos+k``. One batched pass
    (:func:`repro_torch.models.lm.verify_chunk`) gives greedy ``targets``
    at every position; ``accepted (S,)`` is the length of the leading draft
    prefix that matches them (the cumprod of matches), so the host commits
    ``targets[:, :accepted+1]``; ``anchor (S, E)`` is the pre-final-norm
    state at the last committed input position; ``logits (S, k+1, V)``
    those of the pass, for holding a replay against the eager tick
    (``context``, as in :func:`make_pool_decode_step`). Inactive lanes are
    sent to the trash page and keep their input tokens."""
    if k < 1:
        raise ValueError(f"speculative decode needs k >= 1 drafts, got {k}")

    def step(tokens, cur_pos, active, page_table, context=context):
        with torch.no_grad():
            logits, x = lm.verify_chunk(model, tokens, caches, cur_pos,
                                        mask_table(page_table, active),
                                        context=context)
            targets = torch.argmax(logits, dim=-1).to(torch.int32)
            # draft j+1 survives iff it equals the target at position j and
            # every earlier draft survived: the leading-match prefix
            matches = (targets[:, :-1] == tokens[:, 1:]).to(torch.int32)
            accepted = torch.cumprod(matches, dim=1).sum(dim=1)
            accepted = torch.where(active, accepted,
                                   torch.zeros_like(accepted))
            targets = torch.where(active[:, None], targets, tokens)
            rows = torch.arange(tokens.shape[0], device=tokens.device)
            return targets, accepted, x[rows, accepted], logits
    return step

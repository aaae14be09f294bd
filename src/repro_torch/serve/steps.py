"""Pool-wide serve steps: one pooled decode tick and one chunked-prefill
tick over the engine's slots. Counterparts of the serving builders in
``repro.train.steps``; they run eagerly.

Pages are shared physical state and the pool is written in place, so an
inactive lane writing through a stale table row would corrupt a page a
later owner still needs: every step redirects inactive rows of the page
table to the trash page before the model sees it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.paged_attention import TRASH_PAGE
from repro_torch.models import lm


def mask_table(page_table: torch.Tensor, active: torch.Tensor
               ) -> torch.Tensor:
    """``page_table`` with the rows of inactive slots sent to the trash
    page."""
    return torch.where(active[:, None], page_table,
                       torch.full_like(page_table, TRASH_PAGE))


def make_pool_serve_step(model: lm.LM, sample_fn: Optional[Callable] = None
                         ) -> Callable:
    """``step(tokens, caches, cur_pos, active, page_table, generator) ->
    (next_tokens, logits)`` over the whole slot pool: ``tokens (S,)`` each
    slot's previous token, ``cur_pos (S,)`` its write position, ``active
    (S,)`` bool. Inactive slots keep their input token. ``backend``
    (:mod:`repro_torch.kernels.context`) is for holding the kernels
    against the plain versions on the same state."""
    def step(tokens, caches, cur_pos, active, page_table, generator=None,
             backend="auto"):
        with torch.no_grad():
            logits = lm.decode_step(model, tokens, caches, cur_pos,
                                    mask_table(page_table, active),
                                    backend=backend)
            if sample_fn is None:
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                nxt = sample_fn(logits, generator)
            return torch.where(active, nxt, tokens), logits
    return step


def make_chunk_prefill_step(model: lm.LM) -> Callable:
    """``step(tokens, caches, start_pos, last_idx, active, page_table) ->
    (logits, h_last)``: one fixed-size prompt chunk per slot (zeros for
    slots with nothing to prefill this tick)."""
    def step(tokens, caches, start_pos, last_idx, active, page_table):
        with torch.no_grad():
            return lm.prefill_chunk(model, tokens, caches, start_pos,
                                    last_idx, mask_table(page_table, active))
    return step

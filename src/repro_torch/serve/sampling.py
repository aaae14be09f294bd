"""Token sampling for the serving engine: greedy / temperature / top-k /
top-p. ``temperature == 0`` means greedy, and then the generator is not
touched."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class SamplingParams:
    """Sampling policy for one engine.

    * ``temperature`` — ``0.0`` = greedy argmax; ``> 0`` scales logits.
    * ``top_k`` — ``0`` = disabled; else keep the k highest logits.
    * ``top_p`` — ``1.0`` = disabled; else nucleus sampling (the first
      token is always kept). ``top_k`` applies first, then ``top_p``.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingParams()


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator],
                  params: SamplingParams) -> torch.Tensor:
    """Token ids (int32) from ``logits (..., V)`` under ``params``, drawing
    with ``generator`` (ignored when greedy)."""
    if params.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / params.temperature
    if params.top_k and params.top_k < logits.shape[-1]:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if params.top_p < 1.0:
        sorted_logits, order = torch.sort(logits, dim=-1, descending=True)
        probs = torch.softmax(sorted_logits, dim=-1)
        keep_sorted = (probs.cumsum(dim=-1) - probs) < params.top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        logits = logits.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)

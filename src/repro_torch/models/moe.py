"""Mixture-of-Experts layer: top-k routing, capacity dropping, sort-based
dispatch.

Counterpart of ``repro.models.moe`` on one device (its
``_moe_apply_local``). Dispatch is sort-based and never builds the
``(tokens, experts, capacity)`` one-hot tensor:

  1. top-k expert choice per token → flat ``(T·k,)`` expert ids;
  2. the stable rank of each choice within its expert (argsort, then the
     start of each expert's run by ``searchsorted``);
  3. the kept choices (rank < capacity) are copied into an
     ``(X, capacity, E)`` buffer, ``capacity = max(1, int(cf·k·T/X))``;
  4. SiLU-gated expert products ``(X, C, E) x (X, E, F)``, one batched
     matmul each;
  5. gather back in token order and combine, weighted by the renormalised
     router probabilities.

Aux losses: the Switch load balance and the router z-loss.

Every shape is fixed by ``T``, the rows of the call, so the dispatch never
waits for the host and runs inside a captured CUDA graph: no ``.item()``,
no ``nonzero()``, no boolean-mask indexing. ``T`` is part of the function
(which tokens survive depends on it), so the serving ticks hand the MoE
the same rows as the reference's, filler rows included.

Two places differ in form from the reference and not in value:

* ``jax.lax.top_k`` returns the lower index first on ties and
  ``torch.topk`` promises no order, so top-k is a stable descending sort.
* The reference scatter-adds every choice, a dropped one as zeros into
  slot ``capacity - 1``. Here a dropped choice is copied to a spare row
  that is cut off: a kept slot receives its one token (``0 + x = x``) and
  no float is added atomically. The combine reads dropped choices from a
  zero row in the same way.

The reference's expert-parallel path (``_moe_apply_ep``, with
``moe_token_chunk``) shards experts over a mesh's ``model`` axis; it comes
with ROADMAP queue 1, item 6d.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.linear import scaled_normal

#: an aux loss: a 0-d float32 tensor, or 0.0 where none was computed
AuxLoss = Union[torch.Tensor, float]


class MoE(nn.Module):
    """``router (E, X)``, ``w_gate``/``w_up (X, E, F)``, ``w_down (X, F, E)``
    with the reference's ``scaled_normal`` init and fan-in dims (E for the
    router, gate and up; F for down)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        E, Fd, X = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = cfg.pdtype()

        def param(shape, fan_in):
            return nn.Parameter(scaled_normal(generator, shape, fan_in).to(dt))

        self.router = param((E, X), E)
        self.w_gate = param((X, E, Fd), E)
        self.w_up = param((X, E, Fd), E)
        self.w_down = param((X, Fd, E), Fd)


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Expert slots per expert for a call of ``tokens`` rows."""
    return max(1, int(cfg.capacity_factor * cfg.top_k * tokens
                      / cfg.n_experts))


def route(cfg: ModelConfig, moe: MoE, xt: torch.Tensor,
          with_aux: bool = True) -> Tuple[torch.Tensor, torch.Tensor, AuxLoss]:
    """``(top_p (T, k), top_e (T, k), aux)`` for tokens ``xt (T, E)``: the
    float32 router softmax's top k, lower index first on ties,
    renormalised; ``aux`` the weighted load-balance and z-losses, or 0.0
    without ``with_aux`` (serving drops them)."""
    T = xt.shape[0]
    X, k = cfg.n_experts, cfg.top_k
    logits = (xt @ moe.router.to(xt.dtype)).float()                 # (T, X)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    if not with_aux:
        return top_p, top_e, 0.0

    first = torch.zeros(X, dtype=torch.float32, device=xt.device)
    first.scatter_add_(0, top_e[:, 0], torch.ones(T, dtype=torch.float32,
                                                  device=xt.device))
    density = first / T
    lb_loss = X * (density * probs.mean(dim=0)).sum()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    aux = cfg.load_balance_coef * lb_loss + cfg.router_z_coef * z_loss
    return top_p, top_e, aux


def expert_ffn(moe: MoE, buf: torch.Tensor) -> torch.Tensor:
    """The SiLU-gated experts on ``buf (X, C, E)``, weights cast to the
    buffer's dtype on every call, as the reference does."""
    cd = buf.dtype
    g = torch.bmm(buf, moe.w_gate.to(cd))
    u = torch.bmm(buf, moe.w_up.to(cd))
    return torch.bmm(F.silu(g) * u, moe.w_down.to(cd))


def moe_apply(cfg: ModelConfig, moe: MoE, x: torch.Tensor,
              with_aux: bool = True) -> Tuple[torch.Tensor, AuxLoss]:
    """``x (B, S, E)`` → ``(out (B, S, E), aux)``, the reference's
    ``_moe_apply_local``; ``with_aux=False`` skips the aux losses (0.0)."""
    B, S, E = x.shape
    X, k = cfg.n_experts, cfg.top_k
    T = B * S
    dev = x.device
    xt = x.reshape(T, E)
    top_p, top_e, aux = route(cfg, moe, xt, with_aux)

    C = capacity(cfg, T)
    flat_e = top_e.reshape(-1)                                      # (T·k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(X, dtype=sorted_e.dtype, device=dev))
    rank_sorted = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = rank < C
    spare = X * C                     # the row a dropped choice goes to
    dest = torch.where(keep, flat_e * C + rank,
                       torch.full_like(rank, spare))
    tok_idx = torch.arange(T, device=dev).repeat_interleave(k)

    buf = x.new_zeros(spare + 1, E).index_copy(0, dest, xt[tok_idx])
    out_buf = expert_ffn(moe, buf[:spare].reshape(X, C, E))
    out_flat = torch.cat([out_buf.reshape(spare, E), x.new_zeros(1, E)])

    gathered = out_flat[dest]                                       # (T·k, E)
    weighted = gathered.reshape(T, k, E) * top_p[..., None].to(x.dtype)
    return weighted.sum(dim=1).reshape(B, S, E), aux


def moe_dense_reference(cfg: ModelConfig, moe: MoE, x: torch.Tensor
                        ) -> torch.Tensor:
    """All experts on every token, no capacity drops: the oracle for
    tests (the reference's ``moe_dense_reference``)."""
    B, S, E = x.shape
    xt = x.reshape(-1, E)
    T = xt.shape[0]
    top_p, top_e, _ = route(cfg, moe, xt, with_aux=False)
    y = expert_ffn(moe, xt.expand(cfg.n_experts, T, E))             # (X,T,E)
    w = torch.zeros(T, cfg.n_experts, dtype=torch.float32, device=x.device)
    w = w.scatter(1, top_e, top_p)
    out = torch.einsum("tx,xtd->td", w.to(x.dtype), y)
    return out.reshape(B, S, E)

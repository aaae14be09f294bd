"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Counterpart of ``repro.models.rglru``. Block: x → [gate branch: linear +
GeLU] ⊙ [rec branch: linear → causal depthwise conv (width ``conv_width``)
→ RG-LRU] → output linear, with the recurrence::

    r_t = σ(W_a x_t + b_a)              recurrence gate
    i_t = σ(W_x x_t + b_x)              input gate
    a_t = exp(-c · softplus(Λ) ⊙ r_t)   diagonal decay, c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The reference runs training and prefill through ``jax.lax.associative_scan``;
torch has none, so :func:`rglru_scan` is a log-depth doubling scan over the
pairs ``(a, b)`` with the reference's combine ``(a1·a2, a2·b1 + b2)``:
⌈log₂ S⌉ out-of-place steps, which autograd differentiates. A cumulative
product in log space would divide by decays that underflow within a few
dozen steps. Decode is one :func:`rglru_step`.

The serving cache is ``{"h": (B, R) float32, "conv": (B, W-1, R)}`` in the
compute dtype, written in place (:func:`write_state`). A prefill keeps as
conv history the last ``W-1`` rows of ``[zeros(W-1); u]`` (:func:`
conv_history`): zeros on the left for a prompt shorter than ``W-1``. The
reference keeps ``u[:, -(W-1):]`` there, fewer rows than its cache holds,
and its decode after a 1- or 2-token prompt goes wrong (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.linear import scaled_normal

_C = 8.0

#: a cache field: (shape, dtype, init value)
StateSpec = Dict[str, Tuple[Tuple[int, ...], torch.dtype, float]]


class RGLRU(nn.Module):
    """The reference's ``rglru_specs``: ``w_in``/``w_gate_branch`` (E, R),
    ``conv`` (W, R), ``w_a``/``w_x`` (R, R) with biases ``b_a``/``b_x``,
    ``lam`` (R,), ``w_out`` (R, E)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        E, R, W = cfg.d_model, cfg.lru_width_, cfg.conv_width
        dt, g = cfg.pdtype(), generator

        def p(t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t.to(dt))

        self.w_in = p(scaled_normal(g, (E, R), E))
        self.w_gate_branch = p(scaled_normal(g, (E, R), E))
        self.conv = p(scaled_normal(g, (W, R), W, scale=0.5))
        self.w_a = p(scaled_normal(g, (R, R), R))
        self.b_a = p(torch.zeros(R))
        self.w_x = p(scaled_normal(g, (R, R), R))
        self.b_x = p(torch.zeros(R))
        self.lam = p(0.5 * torch.randn((R,), generator=g))
        self.w_out = p(scaled_normal(g, (R, E), R))


def cache_spec(cfg: ModelConfig, batch: int) -> StateSpec:
    """The reference's ``rglru_cache_spec`` and its zero init."""
    R, W = cfg.lru_width_, cfg.conv_width
    return {"h": ((batch, R), torch.float32, 0.0),
            "conv": ((batch, W - 1, R), cfg.cdtype(), 0.0)}


def write_state(cache: Mapping[str, torch.Tensor],
                new: Mapping[str, torch.Tensor]) -> None:
    """Copy each field of ``new`` into ``cache``'s tensor of that name, in
    place (cast to its dtype): the pool's addresses stay fixed, so a
    captured decode graph replays on them."""
    for name, t in new.items():
        cache[name].copy_(t)


def conv_history(u: torch.Tensor, width: int,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The last ``width - 1`` rows of ``[history; u]`` along time, zeros
    standing for a missing ``history``: the conv's inputs a next step
    reads. ``u`` (B, S, R) goes in ``history``'s dtype where there is
    one."""
    B, _, R = u.shape
    if history is None:
        history = u.new_zeros((B, width - 1, R))
    xp = torch.cat([history, u.to(history.dtype)], dim=1)
    return xp[:, xp.shape[1] - (width - 1):]


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over time. x (B, S, R); kernel (W, R);
    history (B, W-1, R) the previous inputs (decode), zeros without."""
    W = kernel.shape[0]
    B, S, R = x.shape
    if history is None:
        history = x.new_zeros((B, W - 1, R))
    xp = torch.cat([history.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for j in range(W):
        out = out + kernel[j].to(x.dtype) * xp[:, j:j + S]
    return out


def _gates(rec: RGLRU, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decay ``a`` and the gated input ``b``, float32 (B, S, R)."""
    cd = x.dtype
    r = torch.sigmoid((x @ rec.w_a.to(cd) + rec.b_a.to(cd)).float())
    i = torch.sigmoid((x @ rec.w_x.to(cd) + rec.b_x.to(cd)).float())
    log_a = -_C * F.softplus(rec.lam.float()) * r
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.maximum(1.0 - torch.square(a),
                                       a.new_full((), 1e-12))) \
        * (i * x.float())
    return a, gated_x


def linear_scan(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along dim 1 from
    ``h = 0``: ``(A, B)`` with ``A_t = a_1 ⋯ a_t`` and ``B_t = h_t``.
    Log-depth doubling (Hillis–Steele): at offset ``d`` each position folds
    in the partial result ``d`` steps before it, the identity ``(1, 0)``
    where there is none."""
    S = a.shape[1]
    d = 1
    while d < S:
        a_prev = torch.cat([torch.ones_like(a[:, :d]), a[:, :-d]], dim=1)
        b_prev = torch.cat([torch.zeros_like(b[:, :d]), b[:, :-d]], dim=1)
        a, b = a_prev * a, a * b_prev + b
        d *= 2
    return a, b


def rglru_scan(rec: RGLRU, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over (B, S, R); returns ``(hs, h_last)``, float32."""
    a, b = _gates(rec, x)
    A, Bc = linear_scan(a, b)
    hs = A * h0[:, None, :] + Bc if h0 is not None else Bc
    return hs, hs[:, -1, :]


def rglru_step(rec: RGLRU, x: torch.Tensor, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x (B, 1, R); h (B, R) float32."""
    a, b = _gates(rec, x)
    h_new = a[:, 0] * h + b[:, 0]
    return h_new[:, None, :], h_new


def rglru_block(cfg: ModelConfig, rec: RGLRU, x: torch.Tensor, *,
                mode: str, cache: Optional[Mapping[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """The Griffin recurrent block over x (B, S, E). ``mode`` is
    ``"train"`` (no cache), ``"prefill"`` (the whole prompt from a fresh
    state; ``cache`` filled in place) or ``"decode"`` (one position from
    ``cache``, updated in place)."""
    cd = x.dtype
    gate = F.gelu(x @ rec.w_gate_branch.to(cd), approximate="tanh")
    u = x @ rec.w_in.to(cd)
    W = cfg.conv_width
    if mode == "decode":
        hist = cache["conv"]
        v = _causal_conv(u, rec.conv, hist)
        hs, h_last = rglru_step(rec, v, cache["h"])
        write_state(cache, {"h": h_last, "conv": conv_history(u, W, hist)})
    else:
        v = _causal_conv(u, rec.conv)
        hs, h_last = rglru_scan(rec, v)
        if mode == "prefill":
            write_state(cache, {"h": h_last, "conv": conv_history(u, W)})
    return (hs.to(cd) * gate) @ rec.w_out.to(cd)

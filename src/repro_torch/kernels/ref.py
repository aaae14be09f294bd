"""Plain PyTorch oracles, counterparts of ``repro.kernels.ref``.

``sandwich_ref`` keeps the reference oracle's form — one-hot selection and
scatter matrices, everything in ``x``'s dtype — so tests can hold it
against the JAX oracle directly. The kernel's own plain twin, with the
kernel's precision points and index arrays, is
:func:`repro_torch.kernels.sandwich.sandwich_plain`; likewise
``flash_attention_ref`` against :func:`repro_torch.kernels.flash.
flash_fwd_plain`.
"""

from __future__ import annotations

import torch

from repro_torch.core import butterfly as bf


def butterfly_ref(w: torch.Tensor, x: torch.Tensor,
                  transpose: bool = False) -> torch.Tensor:
    """``B x`` (or ``Bᵀ x``) over the last axis; ``w`` is (p, 2, n)."""
    if transpose:
        return bf.butterfly_transpose_apply(w, x)
    return bf.butterfly_apply(w, x)


def sandwich_ref(x: torch.Tensor, b_in: torch.Tensor, core: torch.Tensor,
                 b_out: torch.Tensor, sel_in: torch.Tensor,
                 sel_out: torch.Tensor, scale_in: float,
                 scale_out: float) -> torch.Tensor:
    """Oracle of the fused sandwich: ``sel_in`` (n1, k1) one-hot selection,
    ``sel_out`` (k2, n2) one-hot scatter, scales the JL normalizations."""
    dt = x.dtype
    h = bf.butterfly_apply(b_in.to(dt), x)
    h = (h @ sel_in.to(dt)) * torch.tensor(scale_in, dtype=dt)
    h = torch.einsum("...i,oi->...o", h, core.to(dt))
    z = (h @ sel_out.to(dt)) * torch.tensor(scale_out, dtype=dt)
    return bf.butterfly_transpose_apply(b_out.to(dt), z)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """Oracle of flash attention: q/k/v (B, H, S, D), KV heads already
    expanded. Logits ``q·kᵀ`` in the inputs' dtype, then float32 and
    scaled; masked to -1e30 where ``k > q`` (causal) or ``k <= q - window``
    (``window > 0``; without ``causal`` only this bound); softmax; the
    probabilities cast to ``v``'s dtype before ``· v``."""
    S, D = q.shape[-2], q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)

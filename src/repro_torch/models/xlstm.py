"""xLSTM blocks: chunkwise mLSTM (matrix memory) and sLSTM (scalar memory).

Counterpart of ``repro.models.xlstm``. The mLSTM recurrence (stabilized,
per head)::

    m_t = max(f̃_t + m_{t-1}, ĩ_t)                    stabilizer
    f'_t = exp(f̃_t + m_{t-1} - m_t),  i'_t = exp(ĩ_t - m_t)
    C_t = f'_t C_{t-1} + i'_t v_t k_tᵀ               (dv × dk) matrix memory
    n_t = f'_t n_{t-1} + i'_t k_t
    h_t = C_t q_t / max(|n_tᵀ q_t|, exp(-m_t))       (q pre-scaled 1/√dk)

Three equivalent forms, as the reference's: :func:`mlstm_recurrent` (a
Python loop over time carrying (C, n, m): decode, and the state of a
prefill no longer than a chunk), :func:`mlstm_parallel` (the quadratic
masked form) and :func:`mlstm_chunkwise` (a loop over chunks, parallel
within each). The sLSTM keeps per-head scalar state with exponential gating
and a recurrent dependence on h_{t-1} (block-diagonal ``r_zifo`` per head):
:func:`_slstm_scan` is a Python loop over time, as the reference's is a
``lax.scan``. Maxima are ``torch.maximum``/``torch.amax``, which split the
gradient evenly at ties, as ``jnp.maximum``/``jnp.max`` do.

A fresh state has ``m = -inf`` (the reference's ``m0``); the serving caches
start at ``m = -1e30`` (and the sLSTM's ``n`` at 1e-6), as the reference's
inits do (:data:`MLSTM_INIT`, :data:`SLSTM_INIT`). The caches are written
in place (:func:`repro_torch.models.rglru.write_state`); a prefill's conv
history is left-zero-padded (:func:`repro_torch.models.rglru.
conv_history`), where the reference's keeps too few rows after a prompt
shorter than ``conv_width - 1`` (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models.rglru import (StateSpec, _causal_conv, conv_history,
                                      write_state)
from repro_torch.nn.linear import scaled_normal
from repro_torch.runtime import loops

#: the serving caches' init values besides zeros (the reference's
#: ``init_mlstm_cache`` and ``init_slstm_cache``)
MLSTM_INIT = {"m": -1e30}
SLSTM_INIT = {"n": 1e-6, "m": -1e30}

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, head_dim) of the mLSTM block (pf = 2)."""
    d_inner = 2 * cfg.d_model
    H = cfg.n_heads
    return d_inner, H, d_inner // H


def _param(t: torch.Tensor, cfg: ModelConfig) -> nn.Parameter:
    return nn.Parameter(t.to(cfg.pdtype()))


# ---------------------------------------------------------------------------
# mLSTM core math
# ---------------------------------------------------------------------------

def _fresh_state(B: int, H: int, D: int, device) -> State:
    return (torch.zeros((B, H, D, D), device=device),
            torch.zeros((B, H, D), device=device),
            torch.full((B, H), float("-inf"), device=device))


def mlstm_recurrent(q, k, v, igate, fgate, state: Optional[State] = None
                    ) -> Tuple[torch.Tensor, State]:
    """q/k/v (B, S, H, D); igate/fgate preactivations (B, S, H). Returns
    ``(h (B, S, H, D), (C, n, m))``; the forget gate goes through
    log-sigmoid."""
    B, S, H, D = q.shape
    C, n, m = state if state is not None else _fresh_state(B, H, D,
                                                             q.device)
    qf = q.float() * (D ** -0.5)
    kf, vf = k.float(), v.float()
    logf = F.logsigmoid(fgate.float())
    ig = igate.float()
    hs = []
    for t in loops.steps(S):
        qt, kt, vt, ft, it = (qf[:, t], kf[:, t], vf[:, t], logf[:, t],
                              ig[:, t])
        m_new = torch.maximum(ft + m, it)
        fp = torch.exp(ft + m - m_new)
        ip = torch.exp(it - m_new)
        C = fp[..., None, None] * C + ip[..., None, None] \
            * vt[..., :, None] * kt[..., None, :]
        n = fp[..., None] * n + ip[..., None] * kt
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qt)),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return loops.stack(hs, S, dim=1), (C, n, m)


def mlstm_parallel(q, k, v, igate, fgate) -> torch.Tensor:
    """The quadratic masked form (short sequences)."""
    B, S, H, D = q.shape
    qf = q.float() * (D ** -0.5)
    kf, vf = k.float(), v.float()
    logf = F.logsigmoid(fgate.float())                       # (B,S,H)
    ig = igate.float()
    Fc = torch.cumsum(logf, dim=1)
    # log decay matrix: logD[i, j] = F_i - F_j + ig_j  (j <= i)
    logD = Fc[:, :, None, :] - Fc[:, None, :, :] + ig[:, None, :, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    logD = torch.where(mask[None, :, :, None], logD,
                       logD.new_full((), float("-inf")))
    m = torch.amax(logD, dim=2)                               # (B,S,H)
    m = torch.maximum(m, m.new_full((), -1e30))               # rows w/o mass
    Dmat = torch.exp(logD - m[:, :, None, :])
    scores = torch.einsum("bqhd,bkhd->bqkh", qf, kf) * Dmat
    num = torch.einsum("bqkh,bkhd->bqhd", scores, vf)
    den = torch.maximum(torch.abs(scores.sum(dim=2)), torch.exp(-m))
    return num / den[..., None]


def mlstm_chunkwise(q, k, v, igate, fgate, chunk: int,
                    state: Optional[State] = None,
                    return_state: bool = False):
    """A loop over chunks carrying (C, n, m), parallel within each chunk;
    ``S`` must be a multiple of ``min(chunk, S)``."""
    B, S, H, D = q.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence {S} is not a multiple of chunk {c}")
    nc = S // c
    qf = (q.float() * (D ** -0.5)).reshape(B, nc, c, H, D)
    kf = k.float().reshape(B, nc, c, H, D)
    vf = v.float().reshape(B, nc, c, H, D)
    logf = F.logsigmoid(fgate.float()).reshape(B, nc, c, H)
    ig = igate.float().reshape(B, nc, c, H)
    C, n, m = state if state is not None else _fresh_state(B, H, D,
                                                             q.device)
    mask = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    neg_inf = qf.new_full((), float("-inf"))
    floor = qf.new_full((), -1e30)
    hs = []
    for j in loops.steps(nc):
        qc, kc, vc, fc, ic = (qf[:, j], kf[:, j], vf[:, j], logf[:, j],
                              ig[:, j])
        b = torch.cumsum(fc, dim=1)                           # (B,c,H)
        logD = b[:, :, None, :] - b[:, None, :, :] + ic[:, None, :, :]
        logD = torch.where(mask[None, :, :, None], logD, neg_inf)
        m_intra = torch.amax(logD, dim=2)                     # (B,c,H)
        # inter-chunk: the state decayed by b_i, at its stabilizer m
        m_inter = b + m[:, None, :]
        m_i = torch.maximum(torch.maximum(m_intra, m_inter), floor)
        Dm = torch.exp(logD - m_i[:, :, None, :])
        scores = torch.einsum("bqhd,bkhd->bqkh", qc, kc) * Dm
        num = torch.einsum("bqkh,bkhd->bqhd", scores, vc)
        den_intra = scores.sum(dim=2)
        w_state = torch.exp(m_inter - m_i)
        num = num + w_state[..., None] * torch.einsum("bhvk,bqhk->bqhv",
                                                      C, qc)
        den = den_intra + w_state * torch.einsum("bhk,bqhk->bqh", n, qc)
        den = torch.maximum(torch.abs(den), torch.exp(-m_i))
        hs.append(num / den[..., None])
        # the state at the chunk's end
        b_tot = b[:, -1, :]                                   # (B,H)
        g = b_tot[:, None, :] - b + ic                        # token -> end
        m_next = torch.maximum(b_tot + m, torch.amax(g, dim=1))
        w_old = torch.exp(b_tot + m - m_next)
        w_new = torch.exp(g - m_next[:, None, :])
        C = w_old[..., None, None] * C + torch.einsum(
            "bchv,bchk,bch->bhvk", vc, kc, w_new)
        n = w_old[..., None] * n + torch.einsum("bchk,bch->bhk", kc, w_new)
        m = m_next
    hs = loops.stack(hs, nc, dim=1).reshape(B, S, H, D)
    if return_state:
        return hs, (C, n, m)
    return hs


# ---------------------------------------------------------------------------
# mLSTM block (up-proj, conv, qkv, gates, headnorm, gated down-proj)
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """The reference's ``mlstm_specs``: ``w_up`` (E, 2·DI), ``conv`` (W,
    DI), ``wq``/``wk``/``wv`` (DI, DI), ``w_igate``/``w_fgate`` (DI, H) with
    biases ``b_igate`` (zeros) and ``b_fgate`` (ones), ``headnorm`` (DI,),
    ``w_down`` (DI, E)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        E, W = cfg.d_model, cfg.conv_width
        DI, H, _ = _dims(cfg)
        g = generator
        self.w_up = _param(scaled_normal(g, (E, 2 * DI), E), cfg)
        self.conv = _param(scaled_normal(g, (W, DI), W, scale=0.5), cfg)
        self.wq = _param(scaled_normal(g, (DI, DI), DI), cfg)
        self.wk = _param(scaled_normal(g, (DI, DI), DI), cfg)
        self.wv = _param(scaled_normal(g, (DI, DI), DI), cfg)
        self.w_igate = _param(scaled_normal(g, (DI, H), DI, scale=0.1), cfg)
        self.b_igate = _param(torch.zeros(H), cfg)
        self.w_fgate = _param(scaled_normal(g, (DI, H), DI, scale=0.1), cfg)
        self.b_fgate = _param(torch.ones(H), cfg)
        self.headnorm = _param(torch.ones(DI), cfg)
        self.w_down = _param(scaled_normal(g, (DI, E), DI), cfg)


def mlstm_cache_spec(cfg: ModelConfig, batch: int) -> StateSpec:
    """The reference's ``mlstm_cache_spec`` with ``init_mlstm_cache``'s
    values."""
    DI, H, D = _dims(cfg)
    f32 = torch.float32
    shapes = {"C": ((batch, H, D, D), f32), "n": ((batch, H, D), f32),
              "m": ((batch, H), f32),
              "conv": ((batch, cfg.conv_width - 1, DI), cfg.cdtype())}
    return {k: (s, dt, MLSTM_INIT.get(k, 0.0))
            for k, (s, dt) in shapes.items()}


def _pad_steps(t: torch.Tensor, pad: int, value: float = 0.0
               ) -> torch.Tensor:
    """``t`` (B, S, ...) with ``pad`` steps of ``value`` after its last."""
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad), value=value)


def mlstm_block(cfg: ModelConfig, blk: MLSTM, x: torch.Tensor, *,
                mode: str, cache: Optional[Mapping[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """The mLSTM block over x (B, S, E); ``mode`` as in
    :func:`repro_torch.models.rglru.rglru_block`. Training and prefill run
    the parallel form up to a chunk and the chunkwise one past it, padded to
    a multiple of the chunk with state-neutral steps (``ĩ = -1e9``: no
    write; ``f̃ = 1e9``: no decay) whose outputs are dropped; a prefill up
    to a chunk takes its state from :func:`mlstm_recurrent`."""
    B, S, E = x.shape
    DI, H, D = _dims(cfg)
    W = cfg.conv_width
    cd = x.dtype
    up = x @ blk.w_up.to(cd)                                  # (B,S,2DI)
    u, z = up.chunk(2, dim=-1)
    hist = cache["conv"] if mode == "decode" else None
    uc = F.silu(_causal_conv(u, blk.conv, hist))
    q = (uc @ blk.wq.to(cd)).reshape(B, S, H, D)
    k = (uc @ blk.wk.to(cd)).reshape(B, S, H, D)
    v = (u @ blk.wv.to(cd)).reshape(B, S, H, D)
    ig = uc @ blk.w_igate.to(cd) + blk.b_igate.to(cd)
    fg = uc @ blk.w_fgate.to(cd) + blk.b_fgate.to(cd)

    if mode == "decode":
        hs, (C, n, m) = mlstm_recurrent(q, k, v, ig, fg,
                                        (cache["C"], cache["n"], cache["m"]))
        write_state(cache, {"C": C, "n": n, "m": m,
                            "conv": conv_history(u, W, hist)})
    else:
        c = cfg.mlstm_chunk
        pad = (-S) % c
        if pad and S > c:
            q, k, v = (_pad_steps(t, pad) for t in (q, k, v))
            ig = _pad_steps(ig, pad, -1e9)
            fg = _pad_steps(fg, pad, 1e9)
        st = None
        if S <= c:
            hs = mlstm_parallel(q, k, v, ig, fg)
        elif mode == "prefill":
            hs, st = mlstm_chunkwise(q, k, v, ig, fg, c, return_state=True)
        else:
            hs = mlstm_chunkwise(q, k, v, ig, fg, c)
        hs = hs[:, :S]
        if mode == "prefill":
            if st is None:
                _, st = mlstm_recurrent(q[:, :S], k[:, :S], v[:, :S],
                                        ig[:, :S], fg[:, :S])
            write_state(cache, {"C": st[0], "n": st[1], "m": st[2],
                                "conv": conv_history(u, W)})

    h = hs.reshape(B, S, DI).to(cd)
    h = cm.rmsnorm(h, blk.headnorm, cfg.norm_eps)
    h = h * F.silu(z)
    return h @ blk.w_down.to(cd)


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """The reference's ``slstm_specs``: ``w_zifo`` (E, 4E), ``r_zifo`` (H,
    D, 4D) laid out (H, 4, D) along its last axis
    (:func:`_recurrent_matrix`), ``b_zifo`` (4E,), ``groupnorm`` (E,), and
    the gated FFN's ``ffn_gate``/``ffn_up`` (E, F) and ``ffn_down`` (F,
    E)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        E, H = cfg.d_model, cfg.n_heads
        D = E // H
        ffn = _slstm_ffn_dim(cfg)
        g = generator
        self.w_zifo = _param(scaled_normal(g, (E, 4 * E), E), cfg)
        self.r_zifo = _param(scaled_normal(g, (H, D, 4 * D), D, scale=0.5),
                             cfg)
        self.b_zifo = _param(torch.zeros(4 * E), cfg)
        self.groupnorm = _param(torch.ones(E), cfg)
        self.ffn_gate = _param(scaled_normal(g, (E, ffn), E), cfg)
        self.ffn_up = _param(scaled_normal(g, (E, ffn), E), cfg)
        self.ffn_down = _param(scaled_normal(g, (ffn, E), ffn), cfg)


def _slstm_ffn_dim(cfg: ModelConfig) -> int:
    return ((int(cfg.d_model * 4 / 3) + 63) // 64) * 64


def slstm_cache_spec(cfg: ModelConfig, batch: int) -> StateSpec:
    """The reference's ``slstm_cache_spec`` with ``init_slstm_cache``'s
    values."""
    return {t: ((batch, cfg.d_model), torch.float32, SLSTM_INIT.get(t, 0.0))
            for t in ("c", "n", "m", "h")}


def _init_slstm_state(cfg: ModelConfig, B: int, device
                      ) -> Dict[str, torch.Tensor]:
    return {t: torch.full(shape, fill, dtype=dt, device=device)
            for t, (shape, dt, fill) in slstm_cache_spec(cfg, B).items()}


def _recurrent_matrix(r_zifo: torch.Tensor) -> torch.Tensor:
    """``r_zifo`` (H, D, 4D) as one (E, 4E) matrix: block-diagonal over the
    heads, its columns moved from the (H, 4, D) layout to (4, H, D), so
    that ``h @ R`` is the reference's ``_interleave(einsum("bhd,hdf->bhf",
    h, r_zifo))`` (exact zeros off the blocks). The parameter keeps the
    reference's layout, so weights carry across without a permutation."""
    H, D, F4 = r_zifo.shape
    E = H * D
    full = torch.block_diag(*r_zifo)                          # (E, H * 4D)
    return full.reshape(E, H, 4, D).transpose(1, 2).reshape(E, F4 * H)


def _slstm_scan(cfg: ModelConfig, blk: SLSTM, pre: torch.Tensor,
                state: Mapping[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """pre (B, S, 4E) input preactivations (W x + b); the recurrent R h is
    added per step. Sequential by construction: a loop over time, one
    product a step (:func:`_recurrent_matrix`)."""
    S = pre.shape[1]
    R = _recurrent_matrix(blk.r_zifo.float())                 # (E, 4E)
    pre = pre.float()
    c, n, m, h = (state[t] for t in ("c", "n", "m", "h"))
    floor = R.new_full((), 1e-6)
    hs = []
    for t in loops.steps(S):
        z, i, f, o = torch.addmm(pre[:, t], h, R).chunk(4, dim=-1)
        z = torch.tanh(z)
        o = torch.sigmoid(o)
        fm = f + m
        m_new = torch.maximum(fm, i)                          # exp forget
        fp = torch.exp(fm - m_new)
        ip = torch.exp(i - m_new)
        c = torch.addcmul(fp * c, ip, z)
        n = torch.addcmul(ip, fp, n)
        h = o * (c / torch.maximum(n, floor))
        m = m_new
        hs.append(h)
    return loops.stack(hs, S, dim=1), {"c": c, "n": n, "m": m, "h": h}


def slstm_block(cfg: ModelConfig, blk: SLSTM, x: torch.Tensor, *,
                mode: str, cache: Optional[Mapping[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """The sLSTM block and its gated FFN over x (B, S, E); ``mode`` as in
    :func:`repro_torch.models.rglru.rglru_block`. Training and prefill
    start from the init state, whatever ``cache`` holds, as the
    reference's do."""
    B, S, E = x.shape
    cd = x.dtype
    pre = x @ blk.w_zifo.to(cd) + blk.b_zifo.to(cd)
    state = (cache if mode == "decode"
             else _init_slstm_state(cfg, B, x.device))
    hs, new_state = _slstm_scan(cfg, blk, pre, state)
    if mode in ("decode", "prefill"):
        write_state(cache, new_state)
    h = cm.rmsnorm(hs.to(cd), blk.groupnorm, cfg.norm_eps)
    g = F.gelu(h @ blk.ffn_gate.to(cd), approximate="tanh")
    u = h @ blk.ffn_up.to(cd)
    return (g * u) @ blk.ffn_down.to(cd)

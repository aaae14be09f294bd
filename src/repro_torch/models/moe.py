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

**Expert parallelism** (the reference's ``_moe_apply_ep``): under an
ambient sharding context (:func:`repro_torch.runtime.sharding.active_ctx`)
whose mesh has a ``model`` axis larger than 1 that divides ``n_experts``,
:func:`moe_apply` runs one process a rank, global in and global out:

1. the data-parallel axes are picked greedily in the reference's order,
   ``("data", "pod")``, each kept while the batch dim ``B`` divides the
   running product; this rank takes its contiguous block of ``B`` (no
   padding), and the ranks along a dropped axis compute the same tokens;
2. the block's tokens are cut into chunks of ``cfg.moe_token_chunk`` when
   there are more tokens than that and a multiple of it; each chunk is
   routed to all ``X`` experts with its own capacity, and the aux loss is
   the mean over chunks;
3. this ``model`` rank computes its ``X / n_ep`` experts only, on slices of
   the whole weights: every rank keeps the whole weights (ROADMAP "Global
   in, global out"), so the reference's all-gather of their FSDP dim has
   no counterpart here;
4. its partial output is summed over the ``model`` group, the data blocks
   are gathered back into the whole output, and the aux loss is the mean
   over every data block and ``model`` rank.

Every rank then holds the whole output and computes the same whole loss.
The backward of the ``model`` sum is the identity, and of the aux loss's
mean its ``1/n``; each rank's gradients of ``x``, the router and the
experts are then partial (this block, these experts), and one
``all_reduce`` over the data and ``model`` axes a call sums them all
(:class:`~repro_torch.runtime.butterfly_sharding._SumGrads`). The ranks of
a dropped data axis are not summed over: they hold the same values.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.linear import scaled_normal
from repro_torch.runtime import butterfly_sharding as bsh
from repro_torch.runtime.sharding import active_ctx

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
    without ``with_aux`` (serving drops them). ``moe``: anything with the
    MoE's ``router``."""
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
    buffer's dtype on every call, as the reference does. ``moe``: anything
    with the MoE's ``w_gate``, ``w_up`` and ``w_down``."""
    cd = buf.dtype
    g = torch.bmm(buf, moe.w_gate.to(cd))
    u = torch.bmm(buf, moe.w_up.to(cd))
    return torch.bmm(F.silu(g) * u, moe.w_down.to(cd))


class _Weights(NamedTuple):
    """An expert-parallel rank's view of the MoE: the whole router, its
    own experts' slices."""

    router: torch.Tensor
    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor


def _tokens(cfg: ModelConfig, xt: torch.Tensor, moe, first: int,
            with_aux: bool) -> Tuple[torch.Tensor, AuxLoss]:
    """Tokens ``xt (T, E)`` routed to all ``X`` experts with the capacity of
    ``T`` rows, through ``moe``'s experts alone, which are the experts
    ``first, first + 1, ...`` (all of them, or a :class:`_Weights`'
    slices): ``(out (T, E), aux)``, the choices of other experts
    contributing zero rows."""
    T, E = xt.shape
    X, k = cfg.n_experts, cfg.top_k
    n_local = moe.w_gate.shape[0]
    dev = xt.device
    top_p, top_e, aux = route(cfg, moe, xt, with_aux)

    C = capacity(cfg, T)
    flat_e = top_e.reshape(-1)                                      # (T·k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(X, dtype=sorted_e.dtype, device=dev))
    rank_sorted = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    local_e = flat_e - first
    mine = (rank < C) & (local_e >= 0) & (local_e < n_local)
    spare = n_local * C               # the row a dropped choice goes to
    dest = torch.where(mine, local_e * C + rank,
                       torch.full_like(rank, spare))
    tok_idx = torch.arange(T, device=dev).repeat_interleave(k)

    buf = xt.new_zeros(spare + 1, E).index_copy(0, dest, xt[tok_idx])
    out_buf = expert_ffn(moe, buf[:spare].reshape(n_local, C, E))
    out_flat = torch.cat([out_buf.reshape(spare, E), xt.new_zeros(1, E)])

    gathered = out_flat[dest]                                       # (T·k, E)
    weighted = gathered.reshape(T, k, E) * top_p[..., None].to(xt.dtype)
    return weighted.sum(dim=1), aux


def moe_apply(cfg: ModelConfig, moe: MoE, x: torch.Tensor,
              with_aux: bool = True) -> Tuple[torch.Tensor, AuxLoss]:
    """``x (B, S, E)`` → ``(out (B, S, E), aux)``; ``with_aux=False`` skips
    the aux losses (0.0). Expert-parallel on an ambient mesh whose
    ``model`` axis (> 1) divides ``n_experts``, as the reference's
    ``moe_apply`` (module docstring); else its ``_moe_apply_local``."""
    ctx = active_ctx()
    mesh = ctx.mesh if ctx is not None else None
    if (mesh is not None and mesh.shape.get("model", 1) > 1
            and cfg.n_experts % mesh.shape["model"] == 0):
        return _moe_apply_ep(cfg, moe, x, mesh, with_aux)
    B, S, E = x.shape
    out, aux = _tokens(cfg, x.reshape(B * S, E), moe, 0, with_aux)
    return out.reshape(B, S, E), aux


def dp_axes(mesh, batch: int) -> Tuple[str, ...]:
    """The reference's data-parallel axes of an expert-parallel call:
    ``("data", "pod")`` in that order, each kept while ``batch`` divides
    the running product; axes of size 1 are left out (they cut nothing)."""
    axes, prod = [], 1
    for a in ("data", "pod"):
        if a in mesh.shape and batch % (prod * mesh.shape[a]) == 0:
            prod *= mesh.shape[a]
            if mesh.shape[a] > 1:
                axes.append(a)
    return tuple(axes)


def _moe_apply_ep(cfg: ModelConfig, moe: MoE, x: torch.Tensor, mesh,
                  with_aux: bool) -> Tuple[torch.Tensor, AuxLoss]:
    """The reference's ``_moe_apply_ep`` on this rank (module docstring)."""
    B, S, E = x.shape
    n_ep = mesh.shape["model"]
    n_local = cfg.n_experts // n_ep
    dp = dp_axes(mesh, B)
    n_dp = bsh.shard_count(mesh, dp)
    axes = dp + ("model",)
    group = mesh.group(axes)
    x, router, wg, wu, wd = bsh.sum_grads(
        group, (x, moe.router, moe.w_gate, moe.w_up, moe.w_down))

    rows = B // n_dp
    index = mesh.shard_index(dp) if dp else 0
    xl = x[index * rows:(index + 1) * rows].reshape(rows * S, E)
    first = mesh.shard_index(("model",)) * n_local
    mine = _Weights(router, *(w[first:first + n_local]
                              for w in (wg, wu, wd)))
    chunk = cfg.moe_token_chunk
    T = rows * S
    n_chunks = T // chunk if chunk and T > chunk and T % chunk == 0 else 1
    outs, auxs = [], []
    for xc in xl.chunk(n_chunks):
        out, aux = _tokens(cfg, xc, mine, first, with_aux)
        outs.append(out)
        auxs.append(aux)
    y = bsh.all_sum(torch.cat(outs), mesh.group(("model",)))
    y = y.reshape(rows, S, E)
    if dp:
        y = bsh._GatherRows.apply(y, mesh.group(dp), index, n_dp)
    if not with_aux:
        return y, 0.0
    aux = torch.stack(auxs).mean() if n_chunks > 1 else auxs[0]
    # each rank's term of the mean; the gradients summed over the group
    # count every rank's once
    return y, bsh.all_sum(aux, group) / (n_dp * n_ep)


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

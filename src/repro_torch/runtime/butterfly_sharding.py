"""Multi-device execution of the butterfly kernels: rows sharded over the
data axes, weights replicated, weight gradients all-reduced.

Counterpart of ``repro.runtime.butterfly_sharding``. The reference wraps
the fused entry points in ``shard_map``; the port runs one process a rank
(:mod:`repro_torch.runtime.dist`) and does by hand what ``shard_map`` does,
global in and global out. Every rank holds the whole input, the same on
all of them; each rank

1. zero-pads the flattened rows to a multiple of the shard count (the
   product of the data axes' sizes),
2. takes its own rows (:meth:`~repro_torch.launch.mesh.Mesh.shard_index`),
3. runs the *local* kernel on them under the context with the mesh stripped
   (:meth:`~repro_torch.kernels.context.ExecutionContext.local`), so that a
   shard never routes again, and
4. gathers the rows back into the whole output on every rank.

The backward runs the local kernels' existing VJP (:class:`~repro_torch.
kernels.sandwich.SandwichFn`, :class:`~repro_torch.kernels.butterfly.
ButterflyFn`) on this rank's rows of the cotangent, **all-reduces the weight
gradients over the data axes once** a call (one collective over their
concatenation, the reference's explicit ``psum`` of the weight
cotangents), and gathers ``dx`` back into the whole tensor. Three small
autograd Functions carry this (:class:`_TakeRows`, :class:`_GatherRows`,
:class:`_SumGrads`), so the kernels launch exactly as often as unsharded,
``torch.utils.checkpoint`` recomputes a region like any other op, and the
padding rows get zero cotangents (the slice back is linear).

Collectives (:func:`_gather_rows`, :func:`_all_reduce`): the gather is
``all_gather_into_tensor`` and the weight gradients' sum ``all_reduce``,
on every backend. Gloo takes both on CUDA tensors too (ranks sharing one
card; ``chip_smoke.py``'s mesh phase prints every collective the backend
takes there), staging them through host memory itself. Nothing is copied
to the host by this module and nothing falls back to the plain path.
:data:`collectives` counts each kind's calls and the bytes it fills on a
rank, and with ``collectives.timed`` set, its seconds (a synchronisation
before and after each, so only for measurement).

Batch sizes that do not divide the shard count are zero-padded to the next
multiple and sliced back after the region. A rank outside the mesh raises.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import context as exctx

__all__ = ["all_sum", "collectives", "data_axes", "shard_count", "shard_batch_apply",
           "sharded_butterfly_apply", "sharded_butterfly_linear_apply",
           "sharded_route", "sharded_sandwich_apply", "sum_grads"]

# Candidate batch axes, outermost first — the DEFAULT_RULES "batch" entry
# of repro_torch.runtime.sharding.
BATCH_AXIS_CANDIDATES: Tuple[str, ...] = ("pod", "data")


def data_axes(mesh, axes: Optional[Sequence[str]] = None
              ) -> Tuple[str, ...]:
    """Mesh axes to shard rows over: the requested ``axes`` (default
    ``("pod", "data")``) that the mesh has with size > 1. Empty: don't
    shard (callers take the single-device path)."""
    if mesh is None:
        return ()
    cand = BATCH_AXIS_CANDIDATES if axes is None else tuple(axes)
    return tuple(a for a in cand if mesh.shape.get(a, 1) > 1)


def shard_count(mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes) if axes else 1


def sharded_route(ctx: exctx.ExecutionContext) -> Tuple[str, ...]:
    """The axes a finalized context's call shards over, ``()`` for the
    single-device path: the entry points' ``_sharded_route``."""
    if ctx.mesh is None:
        return ()
    return data_axes(ctx.mesh, ctx.mesh_axes)


def _shard_ctx(context: exctx.ContextLike, axes: Optional[Sequence[str]]):
    """(finalized ctx, per-shard local ctx, axes to shard over)."""
    ctx = exctx.resolve_execution(context)
    axes = data_axes(ctx.mesh, ctx.mesh_axes if axes is None else axes)
    return ctx, ctx.local(), axes


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

class CollectiveCounts:
    """Calls, bytes filled on this rank and (when ``timed``) seconds, per
    kind: ``"gather"`` (rows back into the whole tensor, forward outputs
    and backward ``dx``), ``"all_reduce"`` (the weight gradients, and the
    sums of :func:`all_sum`) and ``"shift"`` (a pipeline's handovers,
    :mod:`repro_torch.runtime.pipeline`)."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.stats: Dict[str, Dict[str, float]] = {
            k: {"calls": 0, "bytes": 0, "seconds": 0.0}
            for k in ("gather", "all_reduce", "shift")}

    def _run(self, kind: str, out: torch.Tensor, fn: Callable) -> None:
        s = self.stats[kind]
        s["calls"] += 1
        s["bytes"] += out.numel() * out.element_size()
        if not self.timed:
            fn()
            return
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        t0 = time.perf_counter()
        fn()
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        s["seconds"] += time.perf_counter() - t0


collectives = CollectiveCounts()


# torch 2.13 renames all_gather_into_tensor (kept, deprecated) to
# all_gather_single; older releases have only the first
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _gather_rows(local: torch.Tensor, group, nsh: int) -> torch.Tensor:
    """The ``nsh`` shards' rows (each rank's ``local``) stacked in shard
    order on every rank of ``group``: a group ranks its members in the
    order of their global ranks, which is the order of their shards
    (:meth:`~repro_torch.launch.mesh.Mesh.shard_index`)."""
    local = local.contiguous()
    out = torch.empty((nsh * local.shape[0],) + local.shape[1:],
                      dtype=local.dtype, device=local.device)
    collectives._run("gather", out, lambda: _ALL_GATHER(out, local,
                                                       group=group))
    return out


def _all_reduce(t: torch.Tensor, group) -> None:
    collectives._run("all_reduce", t,
                     lambda: dist.all_reduce(t, group=group))


# ---------------------------------------------------------------------------
# The region's autograd Functions
# ---------------------------------------------------------------------------

class _TakeRows(torch.autograd.Function):
    """This rank's rows of the whole (padded) ``x2``; the backward gathers
    every rank's rows of ``dx`` into the whole gradient."""

    @staticmethod
    def forward(ctx, x2, group, index, nsh):
        ctx.group, ctx.nsh = group, nsh
        rows = x2.shape[0] // nsh
        return x2[index * rows:(index + 1) * rows]

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, ctx.group, ctx.nsh), None, None, None


class _GatherRows(torch.autograd.Function):
    """Every rank's rows of the output stacked into the whole output; the
    backward takes this rank's rows of the cotangent."""

    @staticmethod
    def forward(ctx, yl, group, index, nsh):
        ctx.index, ctx.rows = index, yl.shape[0]
        return _gather_rows(yl, group, nsh)

    @staticmethod
    def backward(ctx, g):
        r = ctx.rows
        return (g[ctx.index * r:(ctx.index + 1) * r].contiguous(), None,
                None, None)


class _SumGrads(torch.autograd.Function):
    """The identity on the replicated weights; the backward all-reduces
    their gradients over the data axes, all of them in one collective."""

    @staticmethod
    def forward(ctx, group, *weights):
        ctx.group = group
        ctx.set_materialize_grads(False)
        return tuple(w.view_as(w) for w in weights)

    @staticmethod
    def backward(ctx, *grads):
        have = [g for g in grads if g is not None]
        if have:
            flat = torch.cat([g.reshape(-1).float() for g in have])
            _all_reduce(flat, ctx.group)
            out, at = [], 0
            for g in grads:
                if g is None:
                    out.append(None)
                    continue
                out.append(flat[at:at + g.numel()].view_as(g).to(g.dtype))
                at += g.numel()
            grads = tuple(out)
        return (None,) + tuple(grads)


class _AllSum(torch.autograd.Function):
    """A tensor summed over ``group`` (in float32); the backward is the
    identity: every rank holds the whole sum and computes the same loss, so
    the cotangent it gets is already its own term's."""

    @staticmethod
    def forward(ctx, t, group):
        total = t.to(torch.float32, copy=True)
        _all_reduce(total, group)
        return total.to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` on every rank of it (:class:`_AllSum`):
    the partial outputs of expert-parallel MoE ranks, a pipeline's last
    stage's outputs."""
    return _AllSum.apply(t, group)


def sum_grads(group, tensors: Sequence[torch.Tensor]
              ) -> Tuple[torch.Tensor, ...]:
    """``tensors`` as they are, those that need a gradient passed through
    :class:`_SumGrads` (one collective over ``group`` in the backward for
    all of them); as they are without a gradient to take."""
    tensors = tuple(tensors)
    trained = [i for i, t in enumerate(tensors) if t.requires_grad]
    if not (trained and torch.is_grad_enabled()):
        return tensors
    out = list(tensors)
    for i, t in zip(trained, _SumGrads.apply(
            group, *(tensors[i] for i in trained))):
        out[i] = t
    return tuple(out)


def shard_batch_apply(fn: Callable, x: torch.Tensor,
                      weights: Sequence[torch.Tensor], mesh,
                      axes: Sequence[str]) -> torch.Tensor:
    """``fn(x2, weights)`` with the flattened rows of ``x`` sharded over
    ``axes`` of ``mesh`` and ``weights`` replicated; ``fn`` maps
    ``(rows, n_in) -> (rows, n_out)``. Rows that do not divide the shard
    count are zero-padded and sliced back; leading axes of ``x`` are
    restored on the output. The weights that need a gradient get it summed
    over the shards."""
    axes = tuple(axes)
    nsh = shard_count(mesh, axes)
    group, index = mesh.group(axes), mesh.shard_index(axes)
    lead = x.shape[:-1]
    b = math.prod(lead)
    x2 = x.reshape(b, x.shape[-1])
    padded = -(-b // nsh) * nsh
    if padded != b:
        x2 = F.pad(x2, (0, 0, 0, padded - b))
    xl = _TakeRows.apply(x2, group, index, nsh)
    y2 = _GatherRows.apply(fn(xl, sum_grads(group, weights)), group, index,
                           nsh)
    return y2[:b].reshape(*lead, y2.shape[-1])


# ---------------------------------------------------------------------------
# The kernels' sharded entry points
# ---------------------------------------------------------------------------

def sharded_butterfly_apply(x: torch.Tensor, w: torch.Tensor, *,
                            context: exctx.ContextLike,
                            axes: Optional[Sequence[str]] = None,
                            transpose: bool = False) -> torch.Tensor:
    """Row-sharded butterfly product (module docstring)."""
    from repro_torch.kernels import butterfly as kb
    ctx, local_ctx, axes = _shard_ctx(context, axes)
    if not axes:
        return kb._local_butterfly_apply(x, w, transpose, local_ctx)
    return shard_batch_apply(
        lambda xl, ws: kb._local_butterfly_apply(xl, ws[0], transpose,
                                                 local_ctx),
        x, (w,), ctx.mesh, axes)


def sharded_sandwich_apply(x: torch.Tensor, b_in: torch.Tensor,
                           core: torch.Tensor, b_out: torch.Tensor,
                           idx_in: torch.Tensor, idx_out: torch.Tensor, *,
                           scale_in: float, scale_out: float, n_out: int,
                           context: exctx.ContextLike,
                           axes: Optional[Sequence[str]] = None
                           ) -> torch.Tensor:
    """Row-sharded butterfly sandwich (module docstring); the arguments of
    :func:`repro_torch.kernels.sandwich.sandwich_forward`."""
    from repro_torch.kernels import sandwich as ks
    ctx, local_ctx, axes = _shard_ctx(context, axes)

    def fn(xl, ws):
        return ks._local_sandwich(xl, ws[0], ws[1], ws[2], idx_in, idx_out,
                                  scale_in, scale_out, n_out, local_ctx)
    if not axes:
        return fn(x, (b_in, core, b_out))
    return shard_batch_apply(fn, x, (b_in, core, b_out), ctx.mesh, axes)


def sharded_butterfly_linear_apply(spec, params: Mapping[str, torch.Tensor],
                                   x: torch.Tensor, *,
                                   context: exctx.ContextLike,
                                   axes: Optional[Sequence[str]] = None
                                   ) -> torch.Tensor:
    """Row-sharded whole sandwich layer: the kernel and the bias run inside
    the region, so the bias gradient is all-reduced with the other
    weights."""
    from repro_torch.core import layers as blayers
    ctx, local_ctx, axes = _shard_ctx(context, axes)
    if not axes:
        return blayers._local_linear_apply(spec, params, x, local_ctx)
    keys = tuple(params)

    def fn(xl, ws):
        return blayers._local_linear_apply(spec, dict(zip(keys, ws)), xl,
                                           local_ctx)
    return shard_batch_apply(fn, x, tuple(params[k] for k in keys),
                             ctx.mesh, axes)

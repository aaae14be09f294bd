"""GPipe pipeline parallelism over a mesh axis, one process a rank.

Counterpart of ``repro.runtime.pipeline``. The layer stack is cut into S
stages along the mesh axis ``stage``; the rank at coordinate s of that axis
runs stage s. Microbatches stream through the GPipe schedule: at tick t
stage s works on microbatch ``t - s`` (when there is one), stage 0 reading
fresh input and every other stage the activation its predecessor handed
over at the tick before; an inactive tick contributes zeros. Bubble
fraction (S-1)/(T+S-1).

As everywhere in the port (ROADMAP "Global in, global out"), every rank
holds the whole input and the whole stacked parameters (a leading stage
dim S), the same on all ranks, and uses its own stage's slice; the last
stage's outputs are summed over the stage group, so every rank returns
them. Ranks that differ only on other axes (``data``) run the same
pipeline on the same input, as the reference's replicated ``P()`` input.

**The handover** is one neighbour shift over the stage group a tick, stage
s to stage s+1. How it moves is chosen by one rule
(:func:`handover_route`): ``batch_isend_irecv`` where the backend takes
point-to-point operations on the tensor's device (NCCL; gloo on CPU
tensors), else an ``all_gather_into_tensor`` over the stage group from
which each rank takes its predecessor's activation (gloo on CUDA tensors:
ranks sharing one card). Both are counted in
:data:`repro_torch.runtime.butterfly_sharding.collectives` as ``"shift"``.

**The backward.** JAX transposes ``ppermute`` into the reverse shift; here
it is written out. :class:`_GPipe` runs the forward schedule with each
tick's stage call recorded as a graph of its own, and its backward walks
the ticks in reverse: at each tick every rank hands the gradient of its
received activation back to its predecessor (the shift the other way),
adds it to the cotangent of its own output, and runs that tick's graph
back. Every rank of the group so takes part in the same shifts in the same
order, whatever its stage. The sum of the outputs has the identity as its
backward; the gradients of the parameters and of ``x`` are partial on each
stage (its slice, stage 0's input) and are summed over the stage group in
one collective (:func:`~repro_torch.runtime.butterfly_sharding.sum_grads`).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

from repro_torch.runtime import butterfly_sharding as bsh

Params = Dict[str, torch.Tensor]

__all__ = ["handover_route", "pipeline_apply", "reference_apply"]


def handover_route(group, device: torch.device) -> str:
    """``"p2p"`` (``batch_isend_irecv``) where ``group``'s backend takes
    point-to-point operations on ``device``'s tensors, else ``"gather"``:
    gloo takes them on CPU tensors only."""
    backend = dist.get_backend(group)
    return "gather" if backend == "gloo" and device.type == "cuda" else "p2p"


def _shift(t: torch.Tensor, group, stage: int, n: int, step: int,
           route: str) -> torch.Tensor:
    """Stage ``s`` sends ``t`` to stage ``s + step`` (mod ``n``) and returns
    what stage ``s - step`` sent it."""
    t = t.contiguous()
    out = torch.empty_like(t)
    src = (stage - step) % n
    if route == "p2p":
        def fn():
            ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(
                       group, (stage + step) % n), group),
                   dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, src), group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        bsh.collectives._run("shift", out, fn)
        return out
    every = torch.empty((n * t.shape[0],) + t.shape[1:], dtype=t.dtype,
                        device=t.device)
    bsh.collectives._run("shift", every, lambda: bsh._ALL_GATHER(
        every, t, group=group))
    return every.view((n,) + t.shape)[src]


class _GPipe(torch.autograd.Function):
    """The schedule on this rank (module docstring): ``mb (T, m, ...)``
    and this stage's parameter tensors in, the last stage's outputs ``(T,
    m, ...)`` out (zeros on the other stages). The gradients it returns
    are dense on every stage (zeros where a stage has none), so that the
    ranks' sums over the group line up."""

    @staticmethod
    def forward(ctx, run, mb, *values):
        stage_fn, keys, group, stage, n, route = run
        ctx.run = run
        T = mb.shape[0]
        leaves = [v.detach().requires_grad_(need)
                  for v, need in zip(values, ctx.needs_input_grad[2:])]
        params = dict(zip(keys, leaves))
        record = any(ctx.needs_input_grad)
        ticks = {}          # microbatch -> (its input leaf, the output)
        outputs = torch.zeros_like(mb)
        inflight = torch.zeros_like(mb[0])
        for t in range(T + n - 1):
            i = t - stage
            sent = torch.zeros_like(inflight)
            if 0 <= i < T:
                x_in = (mb[i] if stage == 0 else inflight).detach()
                x_in.requires_grad_(stage > 0 or ctx.needs_input_grad[1])
                with torch.set_grad_enabled(record):
                    y = stage_fn(params, x_in)
                ticks[i] = (x_in, y)
                sent = y.detach()
                if stage == n - 1:
                    outputs[i] = sent
            if t < T + n - 2:           # the last tick's hands to no one
                inflight = _shift(sent, group, stage, n, 1, route)
        ctx.ticks, ctx.leaves = ticks, leaves
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        _, _, group, stage, n, route = ctx.run
        T = g_out.shape[0]
        g_mb = torch.zeros_like(g_out)
        g_params = [torch.zeros_like(p) for p in ctx.leaves]
        wanted = [k for k, p in enumerate(ctx.leaves) if p.requires_grad]
        g_in = torch.zeros_like(g_out[0])  # of the input at the tick after
        for t in reversed(range(T + n - 1)):
            i = t - stage
            g_y = torch.zeros_like(g_in)
            if t < T + n - 2:
                # the gradient of what this stage handed on at tick t, from
                # its successor's input at tick t + 1 (stage 0 takes fresh
                # input and hands back zeros)
                g_y = _shift(g_in, group, stage, n, -1, route)
            g_in = torch.zeros_like(g_in)
            if i not in ctx.ticks:
                continue
            x_in, y = ctx.ticks[i]
            if stage == n - 1:
                g_y = g_out[i]          # its handed output reaches no one
            inputs = [ctx.leaves[k] for k in wanted] + (
                [x_in] if x_in.requires_grad else [])
            grads = torch.autograd.grad(y, inputs, g_y, allow_unused=True)
            for k, g in zip(wanted, grads):
                if g is not None:
                    g_params[k] += g
            if x_in.requires_grad and grads[-1] is not None:
                if stage == 0:
                    g_mb[i] = grads[-1]
                else:
                    g_in = grads[-1]
        return (None, g_mb) + tuple(g_params)


def pipeline_apply(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                   stage_params: Params, x: torch.Tensor, *, mesh,
                   stage_axis: str = "stage", microbatches: int = 4
                   ) -> torch.Tensor:
    """``y = stage_{S-1}(... stage_0(x))`` pipelined over ``stage_axis`` of
    ``mesh`` (module docstring). ``stage_params``: tensors with a leading
    stage dim S, whole on every rank; ``stage_fn(params_s, x_mb) -> y_mb``
    applies one stage to one microbatch and keeps its shape. ``x``: the
    whole ``(B, ...)`` batch, ``B`` a multiple of ``microbatches``
    (raises otherwise)."""
    n = mesh.shape[stage_axis]
    B = x.shape[0]
    T = microbatches
    if T < 1 or B % T:
        raise ValueError(f"the batch ({B}) must be a multiple of "
                         f"microbatches ({T})")
    keys = tuple(stage_params)
    mb = x.reshape((T, B // T) + x.shape[1:])
    if n == 1:
        params = {k: v[0] for k, v in stage_params.items()}
        return torch.stack([stage_fn(params, m) for m in mb]).reshape(
            x.shape)
    group = mesh.group((stage_axis,))
    stage = mesh.shard_index((stage_axis,))
    route = handover_route(group, x.device)
    mb, *whole = bsh.sum_grads(group, (mb,) + tuple(stage_params[k]
                                                    for k in keys))
    outputs = _GPipe.apply((stage_fn, keys, group, stage, n, route), mb,
                           *(v[stage] for v in whole))
    return bsh.all_sum(outputs, group).reshape(x.shape)


def reference_apply(stage_fn: Callable[[Params, torch.Tensor],
                                       torch.Tensor],
                    stage_params: Params, x: torch.Tensor) -> torch.Tensor:
    """The unpipelined oracle: every stage in turn on the whole batch."""
    n = next(iter(stage_params.values())).shape[0]
    for s in range(n):
        x = stage_fn({k: v[s] for k, v in stage_params.items()}, x)
    return x

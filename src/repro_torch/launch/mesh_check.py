"""The rank side of ``chip_smoke.py``'s mesh phase: work that each rank of a
:func:`repro_torch.runtime.dist.spawn_ranks` world runs and returns to the
parent as plain numbers (it lives in the package because ``spawn``
re-imports the target's module in every rank).

* :func:`probe_collectives` — which collectives the world's backend takes
  on this rank's tensors (on a card shared over gloo: only some), and that
  an ``all_reduce`` sums right.
* :func:`probe_nccl` — one ``all_reduce`` in a one-rank NCCL world, the
  backend a run with a card a rank takes.
* :func:`check_sites` — :func:`~repro_torch.runtime.butterfly_sharding.
  sharded_sandwich_apply` at sandwich sites and :func:`~repro_torch.
  runtime.butterfly_sharding.sharded_butterfly_apply` held against the
  same kernel unsharded on the same inputs, forward and gradients, with
  each rank's launches and collectives.
* :func:`train` — the Trainer on a mesh: losses, a digest of every
  parameter's bytes (ranks must agree bit for bit), the butterfly leaves
  (rank 0), launches per step, step times, peak memory, collectives.
* :func:`phase` — the three rank-side parts of the phase in one world
  (a spawned rank takes seconds to reach a card).
* :func:`serve` — phase 38's rank side: the sharded serving engine on a
  ``(ranks,)`` mesh, rank 0 submitting the requests through its
  :class:`~repro_torch.serve.mesh_serve.MeshServe` and the others
  following it; each rank's tokens, ticks, per-tick wall, launches and
  gathers, and peak memory.
* :func:`ep_pipeline` — phase 39's rank side: the expert-parallel MoE
  layer (:func:`ep_layer`) and a MoE LM (:func:`ep_lm`) on a ``(model,)``
  mesh, and the GPipe pipeline (:func:`pipeline_mlp`) on a ``(stage,)``
  mesh, each held on rank 0 against its run without the mesh.

Every input comes from a seed, the same on every rank.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import butterfly as bf
from repro_torch.kernels import butterfly as kb
from repro_torch.kernels import sandwich as ks
from repro_torch.kernels.context import (ExecutionContext, resolve_execution,
                                         route_context)
from repro_torch.runtime import butterfly_sharding as bsh
from repro_torch.runtime import dist as rdist

COUNTERS = (("sandwich_fwd", ks.sandwich_forward),
            ("sandwich_bwd", ks.sandwich_backward),
            ("butterfly_fwd", kb.butterfly_forward),
            ("butterfly_bwd", kb.butterfly_backward))
LEAVES = ("b_in", "core", "b_out")


def zero_launches() -> None:
    for _, fn in COUNTERS:
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in COUNTERS}


def digest(tensors: Sequence[torch.Tensor]) -> str:
    """sha256 over the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy())
    return h.hexdigest()[:16]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def probe_collectives() -> dict:
    """Each collective tried once on this rank's device; those the backend
    refuses are named with the first line of its error."""
    world = rdist.current_world()
    dev, n = world.device, world.size
    mine = torch.full((4 * n,), float(world.rank + 1), device=dev)
    tries = {
        "all_reduce": lambda: dist.all_reduce(mine.clone()),
        "broadcast": lambda: dist.broadcast(mine.clone(), 0),
        "barrier": dist.barrier,
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(mine) for _ in range(n)], mine),
        "all_gather_into_tensor": lambda: bsh._ALL_GATHER(
            torch.empty(4 * n * n, device=dev), mine),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), mine),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(mine), mine),
    }
    took, refused = [], {}
    for name, fn in tries.items():
        try:
            fn()
            _sync(dev)
            took.append(name)
        except (RuntimeError, ValueError, NotImplementedError) as e:
            refused[name] = (str(e).strip().splitlines() or [""])[0][:160]
    total = mine.clone()
    dist.all_reduce(total)
    want = n * (n + 1) / 2
    if not bool((total == want).all()):
        raise AssertionError(f"all_reduce gave {total[0].item()}, want "
                             f"{want}")
    return {"world": world.describe(), "backend": world.backend,
            "device": str(dev), "took": took, "refused": refused}


def probe_nccl() -> dict:
    """One all_reduce in this (one-rank, NCCL) world: the parent joins
    one for it (:func:`~repro_torch.runtime.dist.init_world`) and leaves
    it."""
    world = rdist.current_world()
    t = torch.ones(1 << 20, device=world.device)
    t0 = time.perf_counter()
    dist.all_reduce(t)
    _sync(world.device)
    ms = (time.perf_counter() - t0) * 1e3
    if world.backend != "nccl" or not bool((t == 1.0).all()):
        raise AssertionError(f"{world.describe()}: all_reduce of ones gave "
                             f"{t[0].item()}")
    return {"world": world.describe(),
            "nccl": ".".join(map(str, torch.cuda.nccl.version())),
            "ms": ms}


def _grads(out: torch.Tensor, g: torch.Tensor, leaves) -> list:
    return list(torch.autograd.grad(out, leaves, g))


def _collective_stats() -> dict:
    return {k: dict(v) for k, v in bsh.collectives.stats.items()}


def _compare(got: list, want: list) -> Tuple[float, float]:
    """(max |Δ| of the first (the forward), max over the rest of |Δ| /
    max|want|)."""
    fwd = float((got[0] - want[0]).abs().max())
    grad = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(got[1:], want[1:]))
    return fwd, grad


def check_sites(sites: Sequence[Tuple[str, object]], rows: Sequence[int],
                butterfly: Tuple[int, int], mesh_shape: Tuple[int, ...],
                kernel: str, seed: int = 0) -> dict:
    """At each of ``sites`` ((name, ButterflySpec)) and each of ``rows``:
    the sandwich's forward and its gradients for a random cotangent
    through :func:`bsh.sharded_sandwich_apply` on ``mesh_shape``, against
    ``kernel`` alone on the same inputs. Then the butterfly at
    ``butterfly`` = (rows, n) the same way. Returns per case the errors,
    this rank's launches of the sharded call, its collectives and a digest
    of its output (ranks must agree)."""
    from repro_torch.core import layers as bl
    world = rdist.current_world()
    dev = world.device
    mesh_ctx = resolve_execution(ExecutionContext(backend=kernel,
                                                  mesh_shape=mesh_shape))
    local = route_context(kernel)
    out = []

    def run(fn, leaves, g, ctx):
        def call():
            y = fn(ctx)
            return [y.detach()] + _grads(y, g, leaves)
        return _run(dev, call, ctx is mesh_ctx)

    for name, spec in sites:
        gen = torch.Generator().manual_seed(seed)
        params = {k: v.to(dev).requires_grad_()
                  for k, v in bl.init_butterfly_linear(gen, spec).items()}
        idx = [torch.tensor(v, dtype=torch.int32, device=dev)
               for v in (spec.idx_in, spec.idx_out)]
        for r in rows:
            x = torch.randn(r, spec.n_in, generator=gen).to(
                dev).requires_grad_()
            g = torch.randn(r, spec.n_out, generator=gen).to(dev)
            leaves = [x, params["b_in"], params["core"], params["b_out"]]

            def fn(ctx):
                return bsh.sharded_sandwich_apply(
                    x, params["b_in"], params["core"], params["b_out"],
                    *idx, scale_in=spec.scale_in, scale_out=spec.scale_out,
                    n_out=spec.n_out, context=ctx)
            want, want_ms, _, _ = run(fn, leaves, g, local)
            got, ms, counts, coll = run(fn, leaves, g, mesh_ctx)
            fwd, grad = _compare(got, want)
            ok = bool(torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-5))
            out.append({"what": f"sandwich {name} {spec.n_in}->"
                                f"{spec.n_out} x {r}", "fwd_err": fwd,
                        "fwd_ok": ok, "grad_err": grad, "ms": ms,
                        "local_ms": want_ms, "launches": counts,
                        "collectives": coll, "digest": digest(got)})
            del x, g, leaves, got, want
    r, n = butterfly
    gen = torch.Generator().manual_seed(seed + 1)
    w = bf.fjlt_weights(gen, n).to(dev).requires_grad_()
    x = torch.randn(r, n, generator=gen).to(dev)
    g = torch.randn(r, n, generator=gen).to(dev)

    def bfn(ctx):
        return bsh.sharded_butterfly_apply(x, w, context=ctx)
    want, want_ms, _, _ = run(bfn, [w], g, local)
    got, ms, counts, coll = run(bfn, [w], g, mesh_ctx)
    fwd, grad = _compare(got, want)
    ok = bool(torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-5))
    out.append({"what": f"butterfly {r} x {n}", "fwd_err": fwd,
                "fwd_ok": ok, "grad_err": grad, "ms": ms,
                "local_ms": want_ms, "launches": counts, "collectives": coll,
                "digest": digest(got)})
    return {"rank": world.rank, "cases": out}


def train(cfg, tc, seq_len: int, batch: int, steps: int,
          leaves: bool) -> dict:
    """``Trainer(cfg, tc)`` ``steps`` steps on this rank's device; with
    ``leaves``, the butterfly leaves after the last step as numpy."""
    from repro_torch.train.trainer import Trainer
    world = rdist.current_world()
    dev = world.device
    trainer = Trainer(cfg, tc, seq_len=seq_len, global_batch=batch,
                      device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    bsh.collectives.reset()
    bsh.collectives.timed = True
    res = trainer.run(steps)
    bsh.collectives.timed = False
    counts = launches()
    named = list(trainer.model.named_parameters())
    return {
        "rank": world.rank, "losses": res.losses,
        "step_times": res.step_times, "mesh_layout": res.mesh_layout,
        "exec": res.execution.describe(),
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "collectives": _collective_stats(),
        "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                     if dev.type == "cuda" else None),
        "digest": digest([p for _, p in named]),
        "leaves": ({n: p.detach().float().cpu().numpy() for n, p in named
                    if n.endswith(LEAVES)} if leaves else None)}


def phase(sites, rows, butterfly, mesh_shape, kernel, cfg, tc, seq_len,
          batch, steps) -> dict:
    """:func:`probe_collectives`, :func:`check_sites` and :func:`train`
    (with the leaves on rank 0) on this rank."""
    return {"probe": probe_collectives(),
            "sites": check_sites(sites, rows, butterfly, mesh_shape,
                                 kernel),
            "train": train(cfg, tc, seq_len, batch, steps,
                           rdist.rank() == 0)}


def mesh_config(cfg, mesh_shape):
    """``cfg`` in float32 compute with ``mesh_shape`` in its butterfly
    config (``None``: unsharded)."""
    return cfg.with_(compute_dtype="float32", butterfly=dataclasses.replace(
        cfg.butterfly, mesh_shape=mesh_shape))


def serve(cfg, prompts, slots: int, max_len: int, chunk: int, max_new: int,
          timeout: float) -> dict:
    """Serve ``prompts`` greedily (``max_new`` tokens each) on this rank's
    engine over a ``(world,)`` mesh: ``cfg`` from seed 0
    (:func:`repro_torch.serve.loader.init_params`, the weights every rank
    and an unsharded run draw alike), ``slots`` lanes of the paged pool at
    ``max_len``, chunks of ``chunk``. Every tick is timed between two
    synchronisations with its launches and gathers (the gathers' seconds
    too: :data:`~repro_torch.runtime.butterfly_sharding.collectives` is
    timed, a synchronisation around each)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import Request, ServeEngine, loader
    from repro_torch.serve.mesh_serve import MeshServe
    world = rdist.current_world()
    dev = world.device
    model = loader.init_params(cfg, seed=0, device=dev)
    engine = ServeEngine(cfg, model, slots=slots, max_len=max_len,
                         prefill_chunk=chunk, device=dev,
                         context=ExecutionContext(mesh_shape=(world.size,)))
    records = []
    step = engine.step

    def timed(now=None):
        m, stats = engine.metrics, bsh.collectives.stats
        before = (m.chunk_ticks, m.decode_steps, ks.sandwich_forward.launches,
                  pa.paged_decode_attention.launches,
                  stats["gather"]["calls"], stats["gather"]["seconds"])
        _sync(dev)
        t0 = time.perf_counter()
        out = step(now)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        after = (m.chunk_ticks, m.decode_steps, ks.sandwich_forward.launches,
                 pa.paged_decode_attention.launches,
                 stats["gather"]["calls"], stats["gather"]["seconds"])
        d = [a - b for a, b in zip(after, before)]
        records.append({"ms": ms, "chunk": d[0], "decode": d[1],
                        "sandwich": d[2], "paged": d[3], "gathers": d[4],
                        "gather_ms": d[5] * 1e3})
        return out

    engine.step = timed
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    bsh.collectives.reset()
    bsh.collectives.timed = True
    try:
        mirror = MeshServe(engine, timeout=timeout)
        if mirror.leader:
            for p in prompts:
                mirror.submit(Request(prompt=p, max_new_tokens=max_new))
            mirror.run_until_idle()
            mirror.stop()
        else:
            mirror.follow()
    finally:
        bsh.collectives.timed = False
    peak = (torch.cuda.max_memory_allocated(dev) / 2**20
            if dev.type == "cuda" else None)
    return {"rank": world.rank, "world": world.describe(),
            "tokens": [f.result(0).tokens for f in mirror.futures],
            "ticks": engine.metrics.ticks, "records": records,
            "peak_mib": peak, "layout": engine.mesh_layout(),
            "captures": engine.graphs.captures}


# ---------------------------------------------------------------------------
# Phase 39: expert parallelism and the GPipe pipeline
# ---------------------------------------------------------------------------

MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")


def _errs(got: torch.Tensor, want: torch.Tensor) -> dict:
    """``max`` |Δ|, ``scale`` max|want|, ``rel`` the relative norm of the
    difference, and whether ``got`` is finite."""
    got, want = got.detach().float(), want.detach().float()
    d = got - want
    return {"max": float(d.abs().max()), "scale": float(want.abs().max()),
            "rel": float(d.norm() / want.norm().clamp_min(1e-30)),
            "finite": bool(torch.isfinite(got).all())}


def _checksums(tensors: Sequence[torch.Tensor]) -> list:
    """Each tensor's float64 sum and sum of magnitudes, reduced on its
    device (the ranks' results compared without copying gigabytes to the
    host)."""
    return [(float(t.double().sum()), float(t.double().abs().sum()))
            for t in tensors]


def _timed(dev: torch.device, fn):
    """``(fn(), milliseconds)`` between two synchronisations."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _run(dev, fn, timed: bool):
    """:func:`_timed` of ``fn`` with the launches and the collectives
    counted from zero (timed collectives on the mesh's run only)."""
    zero_launches()
    bsh.collectives.reset()
    bsh.collectives.timed = timed
    try:
        out, ms = _timed(dev, fn)
    finally:
        bsh.collectives.timed = False
    return out, ms, launches(), _collective_stats()


def ep_layer(arch: str, dtype: str, batch: int, seq: int, chunk: int,
             mesh, seed: int) -> dict:
    """``arch``'s MoE layer at ``(batch, seq)`` tokens in ``dtype`` on the
    ambient mesh ``mesh`` (expert-parallel over its ``model`` axis): the
    forward and the gradients of ``sum(c * y) + aux`` w.r.t. ``x`` and the
    four leaves, timed, with the collectives. On rank 0 also the same
    layer without the mesh, chunk by chunk (``chunk`` tokens, each with
    its own capacity; aux the chunks' mean): the errors of the mesh's run
    against it. Weights and inputs are drawn on the device from
    ``seed``."""
    from repro_torch.configs import registry
    from repro_torch.models import moe as moem
    from repro_torch.runtime import sharding as rsh
    dev = rdist.current_world().device
    cfg = registry.get(arch).with_(compute_dtype=dtype,
                                   moe_token_chunk=chunk)
    E, F = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device("meta"):
        moe = moem.MoE(cfg)
    moe = moe.to_empty(device=dev)
    with torch.no_grad():
        for name, fan_in in (("router", E), ("w_gate", E), ("w_up", E),
                             ("w_down", F)):
            getattr(moe, name).normal_(generator=gen).mul_(fan_in ** -0.5)
    x = torch.randn(batch, seq, E, generator=gen, device=dev).to(
        cfg.cdtype()).requires_grad_()
    c = torch.randn(batch, seq, E, generator=gen, device=dev)
    leaves = [x] + [getattr(moe, n) for n in MOE_LEAVES]

    def grads(y, aux):
        loss = (y.float() * c).sum() + aux
        return [y.detach(), aux.detach()] + list(
            torch.autograd.grad(loss, leaves))

    def on_mesh():
        with rsh.use_sharding(mesh):
            return grads(*moem.moe_apply(cfg, moe, x))

    def alone():
        tokens = x.reshape(-1, 1, chunk, E) if (
            batch * seq > chunk and batch * seq % chunk == 0) else x[None]
        ys, auxs = zip(*(moem.moe_apply(cfg, moe, t) for t in tokens))
        return grads(torch.cat(ys).reshape(x.shape), torch.stack(auxs).mean())

    got, ms, _, coll = _run(dev, on_mesh, True)
    out = {"dtype": dtype, "tokens": batch * seq, "ms": ms,
           "collectives": coll, "checksums": _checksums(got)}
    if rdist.rank() == 0:
        want, out["alone_ms"], _, _ = _run(dev, alone, False)
        out["errs"] = {k: _errs(a, b) for k, a, b in zip(
            ("y", "aux", "x") + MOE_LEAVES, got, want)}
    return out


def ep_lm(arch: str, layers: int, seq: int, batch: int, mesh,
          kernel: str) -> dict:
    """``arch`` at ``layers`` layers in float32 from seed 0: the loss and
    its gradients (one forward and backward, ``batch`` x ``seq`` tokens)
    under the ambient mesh ``mesh``, timed, with the sandwich launches and
    the collectives; on rank 0 also without the mesh on the same model:
    the loss's and each butterfly leaf's gradient's errors."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.runtime import sharding as rsh
    from repro_torch.serve import loader
    dev = rdist.current_world().device
    cfg = registry.get(arch).with_(n_layers=layers, compute_dtype="float32")
    model = loader.init_params(cfg, seed=0, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    ctx = ExecutionContext(backend=kernel)
    named = [(n, p) for n, p in model.named_parameters()
             if n.endswith(LEAVES)]

    def step():
        model.zero_grad(set_to_none=True)
        loss, m = lm.loss_fn(model, {"tokens": tokens, "targets": tokens},
                             context=ctx)
        loss.backward()
        return [loss.detach(), m["aux"].detach()] + [
            p.grad.detach().clone() for _, p in named]

    def on_mesh():
        with rsh.use_sharding(mesh):
            return step()

    got, ms, counts, coll = _run(dev, on_mesh, True)
    out = {"ms": ms, "launches": counts, "collectives": coll,
           "loss": float(got[0]), "aux": float(got[1]),
           "checksums": _checksums(got)}
    if rdist.rank() == 0:
        want, out["alone_ms"], out["alone_launches"], _ = _run(
            dev, step, False)
        out["alone_loss"] = float(want[0])
        out["errs"] = {k: _errs(a, b) for k, a, b in zip(
            ["loss", "aux"] + [n for n, _ in named], got, want)}
    return out


def pipeline_mlp(arch: str, stages: int, batch: int, seq: int, micro: int,
                 mesh, kernel: str) -> dict:
    """``stages`` stacked residual MLP blocks of ``arch`` (``x + down(silu(
    gate(x)) * up(x))`` through its butterfly sites, weights from seed 39)
    on ``x (batch, seq, d_model)`` through :func:`~repro_torch.runtime.
    pipeline.pipeline_apply` over the ``stage`` axis of ``mesh`` with
    ``micro`` microbatches: the output and the gradients of ``sum(c * y)``
    w.r.t. ``x`` and every stacked leaf, timed, with the launches, the
    handover's route and the collectives; on rank 0 also
    :func:`~repro_torch.runtime.pipeline.reference_apply` on the same
    inputs and its errors."""
    from repro_torch.configs import registry
    from repro_torch.core import layers as bl
    from repro_torch.models import common as cm
    from repro_torch.runtime import pipeline as pp
    dev = rdist.current_world().device
    cfg = registry.get(arch)
    bc = cfg.butterfly
    E, F = cfg.d_model, cfg.d_ff
    specs = {name: cm.site_butterfly_spec(bc.seed, key, n_in, n_out,
                                          bc.k_factor, bc.use_bias)
             for name, key, n_in, n_out in (("up", "mlp_up", E, F),
                                            ("gate", "mlp_gate", E, F),
                                            ("down", "mlp_down", F, E))}
    gen = torch.Generator().manual_seed(39)
    drawn = [{f"{name}.{k}": v for name, spec in specs.items()
              for k, v in bl.init_butterfly_linear(gen, spec).items()}
             for _ in range(stages)]
    params = {k: torch.stack([d[k] for d in drawn]).to(
        dev).requires_grad_() for k in drawn[0]}
    dgen = torch.Generator(device=dev).manual_seed(40)
    x = torch.randn(batch, seq, E, generator=dgen,
                    device=dev).requires_grad_()
    c = torch.randn(batch, seq, E, generator=dgen, device=dev)
    ctx = ExecutionContext(backend=kernel)

    def site(p, name, h):
        return bl.butterfly_linear_apply(
            specs[name], {k: p[f"{name}.{k}"] for k in LEAVES}, h,
            context=ctx)

    def stage_fn(p, h):
        return h + site(p, "down", torch.nn.functional.silu(
            site(p, "gate", h)) * site(p, "up", h))

    leaves = [x] + list(params.values())

    def grads(y):
        return [y.detach()] + list(torch.autograd.grad((y * c).sum(),
                                                       leaves))

    def piped():
        return grads(pp.pipeline_apply(stage_fn, params, x, mesh=mesh,
                                       microbatches=micro))

    got, ms, counts, coll = _run(dev, piped, True)
    out = {"ms": ms, "launches": counts, "collectives": coll,
           "route": pp.handover_route(mesh.group(("stage",)), dev),
           "checksums": _checksums(got)}
    if rdist.rank() == 0:
        want, out["alone_ms"], out["alone_launches"], _ = _run(
            dev, lambda: grads(pp.reference_apply(stage_fn, params, x)),
            False)
        out["errs"] = {k: _errs(a, b) for k, a, b in zip(
            ["y", "x"] + list(params), got, want)}
    return out


def ep_pipeline(sizes: dict, kernel: str) -> dict:
    """Phase 39's rank side in one world: :func:`ep_layer` at each of
    ``sizes["layer"]``'s shapes and :func:`ep_lm` on a ``(model,)`` mesh
    of the world, then :func:`pipeline_mlp` on a ``(stage,)`` mesh of
    it."""
    from repro_torch.launch import mesh as tmesh
    world = rdist.current_world()
    n = world.size
    arch, chunk, shapes = sizes["layer"]
    model_mesh = tmesh.make_mesh((n,), ("model",))
    stage_mesh = tmesh.make_mesh((n,), ("stage",))
    out = {"rank": world.rank, "world": world.describe(), "layer": [],
           "walls": {}}
    t0 = time.monotonic()

    def lap(what):
        nonlocal t0
        _free(world.device)
        out["walls"][what] = time.monotonic() - t0
        t0 = time.monotonic()

    for i, (dtype, batch, seq) in enumerate(shapes):
        out["layer"].append(ep_layer(arch, dtype, batch, seq, chunk,
                                     model_mesh, seed=39 + i))
        lap(f"layer {dtype}")
    out["lm"] = ep_lm(*sizes["lm"], model_mesh, kernel)
    lap("lm")
    out["pipeline"] = pipeline_mlp(*sizes["pipeline"], stage_mesh, kernel)
    lap("pipeline")
    if world.device.type == "cuda":
        out["peak_mib"] = torch.cuda.max_memory_allocated(world.device) / 2**20
    return out


def _free(dev: torch.device) -> None:
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

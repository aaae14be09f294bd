"""The rank side of the port's multi-device CPU tests: functions that
``repro_torch.runtime.dist.spawn_ranks`` runs in each rank of a gloo world
and whose numpy results the test modules hold against the JAX reference.

This module imports torch and the port only (never jax or the reference):
``spawn`` re-imports it in every rank, and a rank stays light.
"""

import hashlib
import os

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.core import encdec as tencdec
from repro_torch.core import layers as tlayers
from repro_torch.kernels import butterfly as tkb
from repro_torch.kernels import context as exctx
from repro_torch.kernels import sandwich as tks
from repro_torch.launch import mesh as tmesh
from repro_torch.nn import ButterflyLinear
from repro_torch.runtime import dist as rdist
from repro_torch.runtime import sharding as rsh
from repro_torch.train.trainer import Trainer


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32,
                        requires_grad=grad)


def _np(t):
    return t.detach().numpy()


def _case(case: dict) -> dict:
    """One sharded call on ``case["mesh"]``: its output and the gradients
    of ``sum(c * y)`` (``case["c"]``) w.r.t. the case's leaves."""
    ctx = exctx.ExecutionContext(backend="torch", mesh_shape=case["mesh"])
    kind = case["kind"]
    if kind == "butterfly":
        leaves = [_t(case["x"], True), _t(case["w"], True)]
        y = tkb.butterfly_apply(*leaves, transpose=case["transpose"],
                                context=ctx)
    elif kind == "sandwich":
        spec = case["spec"]
        leaves = [_t(case[k], True) for k in ("x", "b_in", "core", "b_out")]
        idx = [torch.tensor(v, dtype=torch.int32)
               for v in (spec.idx_in, spec.idx_out)]
        y = tks.sandwich_forward(*leaves, *idx, scale_in=case["scale_in"],
                                 scale_out=case["scale_out"],
                                 n_out=spec.n_out, context=ctx)
    elif kind == "linear":
        params = {k: _t(v, True) for k, v in case["params"].items()}
        x = _t(case["x"], True)
        leaves = [x] + [params[k] for k in sorted(params)]
        y = tlayers.butterfly_linear_apply(case["spec"], params, x,
                                           context=ctx)
    elif kind == "nn":
        layer = ButterflyLinear(case["spec"], params={
            k: _t(v) for k, v in case["params"].items()})
        x = _t(case["x"], True)
        leaves = [x] + [p for _, p in sorted(layer.named_parameters())]
        y = layer(x, context=ctx)
    elif kind == "encdec":
        spec = case["spec"]
        params = {k: _t(case["params"][k], True) for k in ("B", "E", "D")}
        X = _t(case["X"])
        xt = tencdec.apply_B(spec, params["B"], X, context=ctx)
        loss = tencdec.loss_fn(spec, params, X, X, context=ctx)
        grads = torch.autograd.grad(loss, [params[k] for k in ("B", "E",
                                                               "D")])
        return {"y": _np(xt), "loss": float(loss),
                "grads": [_np(g) for g in grads]}
    else:
        raise ValueError(kind)
    grads = torch.autograd.grad((y * _t(case["c"])).sum(), leaves)
    return {"y": _np(y), "grads": [_np(g) for g in grads]}


def sharded_cases(cases):
    """Every case on this rank, in order (each builds or reuses its mesh:
    every rank runs the same cases)."""
    return [_case(c) for c in cases]


def cases_and_checks(cases):
    return sharded_cases(cases), resolution_checks()


def resolution_checks() -> dict:
    """The execution context's mesh resolution on this rank's world."""
    n = rdist.world_size()
    out = {}
    shape = (n,)
    ctx = exctx.resolve_execution(exctx.ExecutionContext(mesh_shape=shape))
    out["layout"] = ctx.mesh_layout()
    out["describe"] = ctx.describe()
    out["cached"] = ctx.mesh is tmesh.butterfly_mesh(shape)
    local = ctx.local()
    out["local"] = (local.mesh, local.mesh_shape, local.mesh_axes,
                    local.mesh_layout())
    with exctx.use_execution(ctx):
        again = exctx.resolve_execution(local)
        out["local_stays_local"] = again.mesh is None
        out["ambient_mesh"] = exctx.resolve_execution(None).mesh_layout()
    # an ambient sharding context's mesh is reused at its own shape only
    own = tmesh.make_mesh(shape, ("data",))
    with rsh.use_sharding(own):
        out["reused"] = exctx.resolve_execution(
            exctx.ExecutionContext(mesh_shape=shape)).mesh is own
        if n == 4:
            other = exctx.resolve_execution(
                exctx.ExecutionContext(mesh_shape=(2, 2))).mesh
            out["other_shape"] = (other is not own, other.describe(),
                                  other is tmesh.butterfly_mesh((2, 2)))
    explicit = tmesh.make_mesh(shape, ("data",))
    out["explicit_wins"] = exctx.resolve_execution(exctx.ExecutionContext(
        mesh=explicit, mesh_shape=(1,))).mesh is explicit
    try:
        tmesh.butterfly_mesh((2 * n,))
        out["too_large"] = ""
    except RuntimeError as e:
        out["too_large"] = str(e)
    pod = tmesh.make_mesh((2, n // 2), ("pod", "data"))
    out["pod"] = (pod.shape, pod.coordinate,
                  pod.shard_index(("pod", "data")),
                  pod.shard_index(("data",)))
    # a group ranks its members as their shards are ordered (the gathers
    # stack rows in group-rank order)
    me = torch.distributed.get_rank()
    out["group_ranks"] = [
        torch.distributed.get_group_rank(pod.group(axes), me)
        == pod.shard_index(axes) for axes in (("pod", "data"), ("pod",))
    ] + ([torch.distributed.get_group_rank(pod.group(("data",)), me)
          == pod.shard_index(("data",))] if n > 2 else [])
    return out


def train_runs(tcfg, params_np, specs, runs, ckdir):
    """The Trainer on this rank for each ``(global_batch, steps)`` of
    ``runs`` from the carried-over weights (losses, layout, a digest of the
    parameters), then the checkpoint check in ``ckdir``: 2 steps writing a
    checkpoint at step 2 (the calls to ``save`` on this rank counted), and
    a new Trainer resuming from it for 2 more, both at global batch 8."""
    out = {"runs": []}
    for batch, steps in runs:
        model = convert.from_jax_params(tcfg, params_np, specs, device="cpu")
        res = Trainer(tcfg, TrainConfig(learning_rate=3e-3, warmup_steps=2,
                                        total_steps=20, checkpoint_every=0),
                      seq_len=32, global_batch=batch,
                      device="cpu").run(steps, model=model)
        out["runs"].append({"losses": res.losses,
                            "layout": res.mesh_layout,
                            "exec": res.execution.describe(),
                            "digest": _digest(model)})
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=20,
                     checkpoint_every=2, checkpoint_dir=ckdir)
    trainer = Trainer(tcfg, tc, seq_len=32, global_batch=8, device="cpu")
    saves = []
    save = trainer.ckpt.save
    trainer.ckpt.save = lambda *a, **k: (saves.append(a[0]), save(*a, **k))
    model = convert.from_jax_params(tcfg, params_np, specs, device="cpu")
    head = trainer.run(2, model=model)
    # the carried model again (its index sets are the reference's): the
    # checkpoint holds weights and optimizer state
    model = convert.from_jax_params(tcfg, params_np, specs, device="cpu")
    resumed = Trainer(tcfg, tc, seq_len=32, global_batch=8,
                      device="cpu").run(2, model=model)
    out["ckpt"] = {"saves": saves, "head": head.losses,
                   "resumed_from": resumed.resumed_from,
                   "tail": resumed.losses,
                   "files": sorted(os.listdir(ckdir))}
    return out


def _digest(model) -> str:
    h = hashlib.sha256()
    for _, p in sorted(model.named_parameters()):
        h.update(p.detach().contiguous().view(torch.uint8).numpy())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Sharded serving (tests/test_torch_sharded_serve.py)
# ---------------------------------------------------------------------------

SNAPSHOT_KEYS = ("preempted", "recompute_tokens", "cancelled",
                 "deadline_expired", "requests_finished", "ticks")


def _serve_outcome(fut):
    exc = fut.exception(timeout=0)
    if exc is None:
        return list(fut.result(timeout=0).tokens)
    return type(exc).__name__


def serve_cases(tcfg, params_np, specs, cases, timeout):
    """Each serving case on this rank, every rank's engines over one
    ``(world,)`` mesh: rank 0 plays the case's script through its
    :class:`~repro_torch.serve.mesh_serve.MeshServe` and the others follow
    it. A case is ``{"replicas", "kw", "faults", "script"}``; the script's
    actions are ``("submit", prompt, max_new, request kw)``, ``("step",
    n)``, and a :class:`MeshServe` call with its arguments (``("cancel",
    rid)``, ``("drain", i)``, ``("undrain", i)``, ``("swap_checkpoint",
    i, directory)``); the engines then run until idle. Returns, per case, the outcome of every
    submit (tokens, or the failure's type name), each engine's ticks and
    counters, a digest of every logits tensor sampled here (in order),
    the layout, the gathers a tick took and whether graphs capture."""
    import copy

    from repro_torch.runtime import butterfly_sharding as bsh
    from repro_torch.serve import FaultInjector, Request, Router, ServeEngine
    from repro_torch.serve.mesh_serve import MeshServe
    base = convert.from_jax_params(tcfg, params_np, specs, device="cpu")
    ctx = exctx.ExecutionContext(mesh_shape=(rdist.world_size(),))
    out = []
    for case in cases:
        faults = case.get("faults") or {}
        engines = [ServeEngine(
            tcfg, copy.deepcopy(base), seed=0, device="cpu", context=ctx,
            replica=i, faults=(FaultInjector(at=faults[i]) if i in faults
                               else None), **case["kw"])
            for i in range(case["replicas"])]
        sampled = hashlib.sha256()
        n_sampled = [0]
        for e in engines:
            def hooked(logits, gen, _fn=e._sample_fn):
                sampled.update(logits.detach().contiguous().view(
                    torch.uint8).numpy())
                n_sampled[0] += 1
                return _fn(logits, gen)
            e._sample_fn = hooked
        target = engines[0] if len(engines) == 1 else Router(engines)
        mirror = MeshServe(target, timeout=timeout)
        bsh.collectives.reset()
        if mirror.leader:
            for action in case["script"]:
                kind = action[0]
                if kind == "submit":
                    _, prompt, max_new, kw = action
                    mirror.submit(Request(prompt=prompt,
                                          max_new_tokens=max_new, **kw))
                elif kind == "step":
                    for _ in range(action[1]):
                        mirror.step()
                else:
                    getattr(mirror, kind)(*action[1:])
            mirror.run_until_idle(max_ticks=400)
            mirror.stop()
        else:
            mirror.follow()
        ticks = [e.metrics.ticks for e in engines]
        out.append({
            "outcomes": [_serve_outcome(f) for f in mirror.futures],
            "ticks": ticks, "mirror_ticks": mirror.ticks,
            "counters": [{k: e.metrics.snapshot()[k] for k in SNAPSHOT_KEYS}
                         for e in engines],
            "logits": sampled.hexdigest()[:16], "sampled": n_sampled[0],
            "layout": engines[0].mesh_layout(),
            "gathers": bsh.collectives.stats["gather"]["calls"],
            "captures": engines[0].graphs.captures,
            "dead": ([r.dead is not None for r in target.replicas]
                     if len(engines) > 1 else [False]),
            "swaps": getattr(target, "swaps", 0),
            "errors": [type(e).__name__ for e in mirror.errors]})
    return out


# ---------------------------------------------------------------------------
# Expert parallelism (tests/test_torch_moe_ep.py) and the GPipe pipeline
# (tests/test_torch_pipeline.py)
# ---------------------------------------------------------------------------

MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")


def _meshes():
    """This rank's meshes by (shape, axes), built once a world (building
    one is collective: every rank builds the same ones in the same
    order)."""
    cache = globals().setdefault("_MESHES", {})

    def get(shape, axes):
        key = (tuple(shape), tuple(axes))
        if key not in cache:
            cache[key] = tmesh.make_mesh(*key)
        return cache[key]
    return get


def moe_ep_cases(cases):
    """Each case's ``moe_apply`` on its mesh under the ambient sharding
    context: the output, the aux loss, and the gradients of ``sum(c * y) +
    aux`` w.r.t. ``x`` and the four leaves (numpy), the path taken
    (``"ep"`` when a ``model`` collective ran) and the data axes."""
    from repro_torch.configs import registry as treg
    from repro_torch.models import moe as tmoe
    from repro_torch.runtime import butterfly_sharding as bsh
    mesh_of = _meshes()
    out = []
    for case in cases:
        cfg = treg.get(case["arch"]).with_(compute_dtype="float32",
                                            **case["cfg"])
        moe = tmoe.MoE(cfg)
        with torch.no_grad():
            for name in MOE_LEAVES:
                getattr(moe, name).copy_(torch.from_numpy(
                    case["params"][name]))
        x = _t(case["x"], True)
        mesh = mesh_of(case["mesh"], case["axes"])
        bsh.collectives.reset()
        with rsh.use_sharding(mesh):
            y, aux = tmoe.moe_apply(cfg, moe, x)
        loss = (y * _t(case["c"])).sum() + aux
        leaves = [x] + [getattr(moe, n) for n in MOE_LEAVES]
        grads = torch.autograd.grad(loss, leaves)
        out.append({"y": _np(y), "aux": float(aux.detach()),
                    "grads": [_np(g) for g in grads],
                    "all_reduces": bsh.collectives.stats["all_reduce"][
                        "calls"],
                    "dp": tmoe.dp_axes(mesh, x.shape[0])})
    return out


def _tanh_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def pipeline_cases(cases):
    """Each case through ``pipeline_apply`` on its mesh: the output and the
    gradients of ``sum(y ** 2)`` w.r.t. ``w``, ``b`` and ``x``, and the
    shifts it took; ``"raises"`` cases give the error's text instead."""
    from repro_torch.runtime import butterfly_sharding as bsh
    from repro_torch.runtime import pipeline as tpipe
    mesh_of = _meshes()
    out = []
    for case in cases:
        mesh = mesh_of(case["mesh"], case["axes"])
        params = {k: _t(case[k], True) for k in ("w", "b")}
        x = _t(case["x"], True)
        if case.get("raises"):
            try:
                tpipe.pipeline_apply(_tanh_stage, params, x, mesh=mesh,
                                     microbatches=case["T"])
                out.append({"error": ""})
            except ValueError as e:
                out.append({"error": str(e)})
            continue
        bsh.collectives.reset()
        rule = tpipe.handover_route
        # the all-gather that stands in for point-to-point operations
        # where the backend takes none (gloo on CUDA tensors), taken here
        # on CPU tensors by overriding the rule
        if case["handover"] == "gather":
            tpipe.handover_route = lambda group, device: "gather"
        try:
            y = tpipe.pipeline_apply(_tanh_stage, params, x, mesh=mesh,
                                     microbatches=case["T"])
            grads = torch.autograd.grad((y ** 2).sum(),
                                        [params["w"], params["b"], x])
        finally:
            tpipe.handover_route = rule
        shifts = bsh.collectives.stats["shift"]
        out.append({"y": _np(y), "grads": [_np(g) for g in grads],
                    "shifts": shifts["calls"], "shift_bytes": shifts["bytes"],
                    "route": rule(mesh.group(("stage",)), x.device)})
    return out

"""The dry-run for one H100: every (arch × shape) cell's step built on
``meta`` tensors, tallied, and held against the card's roofline.

Counterpart of ``repro.launch.dryrun`` (``python -m
repro_torch.launch.dryrun``). The reference AOT-compiles each cell for a
TPU pod and reads ``memory_analysis()`` and the compiled HLO; the port has
no compiled artifact, so per cell it

* builds the model and the step's inputs on ``meta``
  (:mod:`repro_torch.launch.specs`): no allocation, no kernel launch;
* counts the step's FLOPs and bytes with the op tally
  (:mod:`repro_torch.launch.op_analysis`): a training step is the loss's
  forward and backward over each of ``choose_microbatches`` microbatches
  (the loops counted once and multiplied), the global-norm clip and the
  AdamW update; a prefill cell is the whole-prompt prefill into dense
  caches, a decode cell one decode step over them;
* counts the step's argument bytes: the parameters, Adam's two moments
  (training), the batch and the caches at the cell's shape;
* writes ``<arch>__<shape>__h100x1.json`` with the roofline terms
  (:class:`repro_torch.launch.roofline.RooflineReport`), the model FLOPs,
  the tally and ``hbm_fit``.

How fit is judged: XLA's ``memory_analysis`` gives the compiled step's
temporaries; the port has no count of them without running, so fit is
judged on the argument bytes alone against the card's 80 GB, and each JSON
says so (``fit_basis``). The reference's half-batch prefill retry is
decided on the same count.

``--mesh`` picks the meshes: ``h100x1`` (the default, one card),
``single`` and ``multi`` (the reference's production pods ``pod16x16``,
``data`` 16 × ``model`` 16, and ``pod2x16x16``, ``pod`` 2 × ``data`` 16 ×
``model`` 16), or ``all``. A pod is laid out by its layout alone
(:func:`repro_torch.launch.mesh.production_layout`): it needs no world of
256 or 512 ranks. A pod cell writes ``<arch>__<shape>__<mesh>.json`` with

* the argument bytes a card, from the sharding trees
  (:func:`~repro_torch.launch.specs.param_shardings`, ``batch_shardings``,
  ``cache_shardings``; Adam's moments as the parameters; each dim divided
  by the product of its mesh axes, rounded up), and ``hbm_fit`` on them;
* ``model_flops(cfg, shape, n_devices)``, and the roofline terms of one
  H100 with the one-card tally spread by the sharding trees
  (:func:`per_card_terms`): the weights' traffic divided by their specs'
  axes other than ``pod``/``data`` (FSDP gathers a weight whole on every
  data-parallel card before it is read), the optimizer state's and the
  caches' by all of their axes, every other byte (the activations) by
  the batch's axes, the FLOPs by the batch's axes and ``model``;
* ``executes``: what the port runs today on such a mesh
  (:func:`executes`): the butterfly sites' rows over ``pod``/``data``
  (:mod:`repro_torch.runtime.butterfly_sharding`), and for a MoE arch
  whose ``n_experts`` the ``model`` axis divides, the MoE layers' experts
  over ``model`` and their tokens over ``pod``/``data``
  (:mod:`repro_torch.models.moe`, the reference's expert parallelism);
  the ``model`` axis is accounting only for every other tensor, the port
  having no tensor parallelism;
* ``collectives``: not modelled (the reference reads them from the
  compiled HLO; the port has none to read), said in the record.

The tally of an (arch, shape, batch) is made once and shared by every
mesh of a run.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback
from dataclasses import replace
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import (SHAPES, SHAPES_BY_NAME, ModelConfig,
                                      ShapeConfig, TrainConfig,
                                      cell_applicable)
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import _Layout, production_layout
from repro_torch.launch.op_analysis import OpTally
from repro_torch.models import lm

MESH = "h100x1"
#: ``--mesh`` choices -> the meshes' names; a pod's ``multi_pod`` flag
MESH_CHOICES = {"h100x1": ("h100x1",), "single": ("pod16x16",),
                "multi": ("pod2x16x16",),
                "all": ("h100x1", "pod16x16", "pod2x16x16")}
PODS = {"pod16x16": False, "pod2x16x16": True}
FIT_BASIS = ("argument bytes (params, Adam's moments, batch, caches): the "
             "temporaries of a step have no count without running it")
COLLECTIVES = ("not modelled: the reference reads its collectives from the "
               "compiled HLO, and the port has no compiled program to read")


def choose_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                        n_dp: int = 1) -> int:
    """Bound per-microbatch tokens so activations fit: ~4k tokens a
    microbatch for wide models, ~8k otherwise (the reference's rule)."""
    local_batch = max(1, shape.global_batch // n_dp)
    target_tokens = 4096 if cfg.d_model >= 1024 else 8192
    seqs_per_mb = max(1, target_tokens // shape.seq_len)
    return max(1, local_batch // seqs_per_mb)


def argument_bytes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, int]:
    """The bytes a step's arguments hold on the card, by part: the
    parameters; for training Adam's two float32 moments and the batch; for
    prefill the batch and the caches; for decode the token, the caches
    and the position."""
    params = sp.tensor_bytes(dict(sp.abstract_model(cfg).named_parameters()))
    parts = {"params": params}
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        n = sp.param_counts(cfg)[0]
        parts["adam_moments"] = 2 * 4 * n + 4
        parts["batch"] = sp.tensor_bytes(sp.batch_specs(cfg, shape))
    elif shape.kind == "prefill":
        parts["batch"] = sp.tensor_bytes(sp.batch_specs(cfg, shape))
        parts["caches"] = sp.tensor_bytes(sp.cache_specs(cfg, B, S))
    else:
        token, caches, cur = sp.decode_specs(cfg, shape)
        parts["batch"] = sp.tensor_bytes([token, cur])
        parts["caches"] = sp.tensor_bytes(caches)
    parts["total"] = sum(parts.values())
    return parts


#: the mesh axes FSDP gathers a weight over before it is read
_GATHERED = ("pod", "data")
_SCALAR = torch.empty((), dtype=torch.int32, device=sp.META)


def _ungathered(spec) -> tuple:
    """``spec`` without the :data:`_GATHERED` axes."""
    def keep(entry):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        axes = tuple(a for a in axes if a not in _GATHERED)
        return axes or None
    return tuple(keep(e) for e in spec)


@functools.lru_cache(maxsize=None)
def _param_bytes(cfg: ModelConfig, layout) -> Dict[str, int]:
    """On a card of the mesh ``layout`` (its ``(axis, size)`` pairs),
    shared by every shape of an arch: the parameters it stores, Adam's two
    float32 moments and the step's count, and the parameters it reads
    (gathered over ``pod``/``data``); with the one-card parameters."""
    mesh = _Layout(tuple(n for _, n in layout), tuple(a for a, _ in layout))
    named = dict(sp.abstract_model(cfg).named_parameters())
    pspec = sp.param_shardings(cfg, mesh)
    f32 = {k: torch.empty(t.shape, dtype=torch.float32, device=sp.META)
           for k, t in named.items()}
    return {"params": sp.tree_bytes(named, pspec, mesh),
            "adam_moments": (2 * sp.tree_bytes(f32, pspec, mesh)
                             + sp.sharded_bytes(_SCALAR, sp.replicated(mesh),
                                                mesh)),
            "params_read": sp.tree_bytes(
                named, {k: _ungathered(v) for k, v in pspec.items()}, mesh),
            "params_one_card": sp.tensor_bytes(named)}


def argument_bytes_per_card(cfg: ModelConfig, shape: ShapeConfig,
                            mesh) -> Dict[str, int]:
    """:func:`argument_bytes` on one card of ``mesh`` under the sharding
    trees (:mod:`repro_torch.launch.specs`): Adam's moments shard as their
    parameters; the step's count and the decode position are
    replicated."""
    held = _param_bytes(cfg, tuple(mesh.shape.items()))
    parts = {"params": held["params"]}
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        parts["adam_moments"] = held["adam_moments"]
        parts["batch"] = sp.tree_bytes(sp.batch_specs(cfg, shape),
                                       sp.batch_shardings(cfg, shape, mesh),
                                       mesh)
    elif shape.kind == "prefill":
        parts["batch"] = sp.tree_bytes(sp.batch_specs(cfg, shape),
                                       sp.batch_shardings(cfg, shape, mesh),
                                       mesh)
        parts["caches"] = sp.tree_bytes(sp.cache_specs(cfg, B, S),
                                        sp.cache_shardings(cfg, shape, mesh),
                                        mesh)
    else:
        token, caches, cur = sp.decode_specs(cfg, shape)
        tspec = sp.batch_shardings(cfg, shape, mesh)["tokens"]
        parts["batch"] = (sp.sharded_bytes(token, tspec, mesh)
                          + sp.sharded_bytes(cur, sp.replicated(mesh), mesh))
        parts["caches"] = sp.tree_bytes(caches,
                                        sp.cache_shardings(cfg, shape, mesh),
                                        mesh)
    parts["total"] = sum(parts.values())
    return parts


def per_card_terms(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   tally: OpTally, passes: float = 1.0
                   ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one card of ``mesh`` from the one-card
    ``tally``, spread by the sharding trees: the weights' traffic as the
    parameters a card reads (:func:`_param_bytes`), times ``passes`` (a
    training cell's microbatches on the mesh over the tally's), the
    optimizer state's as the parameters a card stores, the caches' as the
    caches a card stores, every other byte over the mesh axes of the
    batch dim; the FLOPs over those and ``model``. A weight-gradient
    write counts with the activations, so a training cell's bytes are
    low by up to the parameters' size a microbatch."""
    held = _param_bytes(cfg, tuple(mesh.shape.items()))
    one = held["params_one_card"]
    group = tally.bytes_by_group
    caches = 1.0
    if group["caches"]:
        whole = sp.cache_specs(cfg, shape.global_batch, shape.seq_len)
        caches = (sp.tree_bytes(whole, sp.cache_shardings(cfg, shape, mesh),
                                mesh) / sp.tensor_bytes(whole))
    spec = sp.batch_shardings(cfg, shape, mesh)["tokens"]
    entry = spec[0] if len(spec) else None
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    n_batch = 1
    for a in axes:
        n_batch *= mesh.shape[a]
    rest = tally.bytes - sum(group.values())
    nbytes = (group["weights"] * passes * held["params_read"] / one
              + group["state"] * held["params"] / one
              + group["caches"] * caches + rest / n_batch)
    return tally.flops / (n_batch * mesh.shape.get("model", 1)), nbytes


def _tally_train(cfg: ModelConfig, shape: ShapeConfig, mb: int,
                 model: lm.LM) -> OpTally:
    from repro_torch.optim import optimizer as opt
    from repro_torch.train import steps as steps_lib
    micro = replace(shape, global_batch=max(1, shape.global_batch // mb))
    batch = sp.batch_specs(cfg, micro)
    params = steps_lib.trainable(model)
    names = list(params)
    tx = steps_lib.make_optimizer(TrainConfig(), cfg)
    # the update's work per leaf depends on its shape alone: one leaf of
    # each shape, counted once for each leaf of that shape
    groups: Dict[tuple, list] = {}
    for n, p in params.items():
        groups.setdefault((tuple(p.shape), p.dtype), []).append(n)
    one = {k: {ns[0]: params[ns[0]]} for k, ns in groups.items()}
    states = {k: tx.init(p) for k, p in one.items()}
    tally = OpTally()
    tally.mark(params.values(), "weights")
    with tally:
        with tally.repeat(mb):
            loss, _ = lm.loss_fn(model, batch)
        # the backward takes its multipliers from the forward's scopes
        torch.autograd.grad(loss, [params[n] for n in names],
                            allow_unused=True)
        for k, ns in groups.items():
            p = one[k]
            g = {n: torch.empty(t.shape, dtype=torch.float32,
                                device=t.device) for n, t in p.items()}
            with tally.repeat(len(ns)), tally.state():
                if mb > 1:
                    with tally.repeat(mb):     # gsum += g.float()
                        for n, t in g.items():
                            torch.empty_like(t).add_(t)
                opt.global_norm(g)
                updates, _ = tx.update(g, states[k], p)
                with torch.no_grad():
                    opt.apply_updates(p, updates)
    return tally


def _tally_serve(cfg: ModelConfig, shape: ShapeConfig,
                 model: lm.LM) -> OpTally:
    B, S = shape.global_batch, shape.seq_len
    tally = OpTally()
    tally.mark(model.parameters(), "weights")
    with torch.no_grad():
        if shape.kind == "prefill":
            batch = sp.batch_specs(cfg, shape)
            caches = sp.cache_specs(cfg, B, S)
            tally.mark(caches.values(), "caches")
            extras = {k: batch[k] for k in ("frontend_embeds", "frames")
                      if k in batch}
            with tally:
                lm.prefill(model, batch["tokens"], caches, **extras)
        else:
            token, caches, cur = sp.decode_specs(cfg, shape)
            tally.mark(caches.values(), "caches")
            with tally:
                lm.decode_step(model, token, caches, cur)
    return tally


#: the tallies of this process: (arch, shape, batch, microbatches) ->
#: (OpTally, seconds); every mesh of a run shares them
_TALLIES: Dict[tuple, tuple] = {}


def _tally(arch: str, cfg: ModelConfig, shape: ShapeConfig, mb: int):
    key = (arch, shape.name, shape.global_batch, mb)
    if key not in _TALLIES:
        t0 = time.monotonic()
        model = sp.abstract_model(cfg)
        tally = (_tally_train(cfg, shape, mb, model) if shape.kind == "train"
                 else _tally_serve(cfg, shape, model))
        _TALLIES[key] = (tally, time.monotonic() - t0)
    return _TALLIES[key]


def executes(cfg: ModelConfig, layout) -> Dict:
    """What the port runs on a mesh of ``layout``: the axes the butterfly
    sites' rows shard over (``sharded``), the axes the MoE experts run
    over (``experts``: ``["model"]`` where that axis, larger than 1,
    divides ``n_experts``, as the reference's ``moe_apply`` decides), and
    the axes that are accounting only for every other tensor."""
    model = layout.shape.get("model", 1)
    ep = bool(cfg.n_experts) and model > 1 and cfg.n_experts % model == 0
    what = "the butterfly sites' rows (runtime/butterfly_sharding.py)"
    if ep:
        what += (", the MoE layers' experts over model and their tokens "
                 "over pod/data (models/moe.py)")
    return {"sharded": [a for a in ("pod", "data") if a in layout.shape],
            "experts": ["model"] if ep else [],
            "what": what + "; every other tensor whole on every rank",
            "accounting_only": ["model"] if "model" in layout.shape else []}


def run_cell(arch: str, shape_name: str, out_dir: Optional[str] = None,
             verbose: bool = True, mesh: str = MESH) -> Dict:
    """One cell on ``mesh`` (``h100x1`` or a pod of :data:`PODS`): its
    JSON record (written to ``out_dir`` when given)."""
    cfg = registry.get(arch)
    shape = SHAPES_BY_NAME[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    result: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh}
    if not ok:
        result.update(status="skipped", reason=reason)
        return _write(result, out_dir)

    layout = None if mesh == MESH else production_layout(
        multi_pod=PODS[mesh])
    n_devices = 1 if layout is None else layout.size
    n_dp = 1 if layout is None else (layout.shape.get("pod", 1)
                                     * layout.shape["data"])

    def args_of(shape):
        return (argument_bytes(cfg, shape) if layout is None
                else argument_bytes_per_card(cfg, shape, layout))

    args = args_of(shape)
    mb = 1
    if shape.kind == "train":
        mb = choose_microbatches(cfg, shape, n_dp)
        result["microbatches"] = mb
    elif shape.kind == "prefill":
        result["prefill_chunks"] = 1
        if (args["total"] > rl.HBM_BYTES
                and shape.global_batch % (2 * n_dp) == 0):
            # serving splits an oversized prefill batch over two calls;
            # the terms below are per call
            shape = ShapeConfig(shape.name, shape.seq_len,
                                shape.global_batch // 2, shape.kind)
            result["batch_split"] = 2
            args = args_of(shape)
    # a training step's tally is one card's, at its one-card microbatches:
    # its FLOPs and activation bytes do not depend on how the batch is cut,
    # its weight reads scale with the microbatches
    mb_one = choose_microbatches(cfg, shape) if shape.kind == "train" else 1
    tally, tally_s = _tally(arch, cfg, shape, mb_one)

    mf, tokens = sp.model_flops(cfg, shape, n_devices)
    total, active = sp.param_counts(cfg)
    flops, nbytes = ((tally.flops, tally.bytes) if layout is None
                     else per_card_terms(cfg, shape, layout, tally,
                                         mb / mb_one))
    report = rl.RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh, n_devices=n_devices,
        flops_per_device=flops, bytes_per_device=nbytes,
        argument_bytes=args["total"], model_flops=mf, params_total=total,
        params_active=active, tokens=tokens)
    result.update(report.to_dict())
    result.update(status="ok", tally_seconds=round(tally_s, 3),
                  argument_parts=args, fit_basis=FIT_BASIS,
                  tally=tally.to_dict(), card=rl.CARD)
    if layout is not None:
        result.update(
            mesh_shape=layout.shape, collectives=COLLECTIVES,
            executes=executes(cfg, layout),
            terms_basis="the one-card tally spread by the sharding "
                        "trees: weight traffic over the weights' axes "
                        "but pod/data (FSDP gathers them), optimizer "
                        "state and caches over all of their axes, the "
                        "rest over the batch's axes; FLOPs over the "
                        "batch's axes and model")
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh}] tallied in {tally_s:.1f}s")
        print(f"  arguments{' a card' if layout is not None else ''}: "
              f"{args['total'] / 1e9:.2f} GB "
              f"({', '.join(f'{k} {v / 1e9:.2f}' for k, v in args.items() if k != 'total')})")
        print(f"  tally: flops={tally.flops:.3e} (matmul "
              f"{tally.matmul_flops:.3e}) bytes={tally.bytes:.3e}")
        print(f"  roofline: compute={report.t_compute * 1e3:.2f}ms "
              f"memory={report.t_memory * 1e3:.2f}ms "
              f"dominant={report.dominant} "
              f"util={report.flops_utilization:.2f} fit={report.hbm_fit}")
    return _write(result, out_dir)


def _write(result: Dict, out_dir: Optional[str]) -> Dict:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{result['arch']}__{result['shape']}"
                                     f"__{result['mesh']}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def run(archs, shapes, out_dir: Optional[str] = None, verbose: bool = True,
        stop_on_error: bool = False, meshes=(MESH,)) -> Dict:
    """Every cell of ``archs`` × ``shapes`` × ``meshes``; returns
    ``{"results", "failures", "seconds"}``."""
    t0 = time.monotonic()
    results, failures = [], 0
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                try:
                    results.append(run_cell(arch, shape, out_dir, verbose,
                                            mesh))
                except Exception as e:
                    failures += 1
                    print(f"[FAIL {arch} × {shape} × {mesh}]: {e}")
                    traceback.print_exc(limit=4)
                    if stop_on_error:
                        raise
    return {"results": results, "failures": failures,
            "seconds": time.monotonic() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--stop-on-error", action="store_true")
    ap.add_argument("--mesh", default="h100x1", choices=tuple(MESH_CHOICES),
                    help="h100x1 (one card), single (pod16x16), multi "
                         "(pod2x16x16) or all")
    args = ap.parse_args(argv)
    archs = registry.names() if args.arch == "all" else args.arch.split(",")
    shapes = ([s.name for s in SHAPES] if args.shape == "all"
              else args.shape.split(","))
    out = run(archs, shapes, args.out, stop_on_error=args.stop_on_error,
              meshes=MESH_CHOICES[args.mesh])
    res = out["results"]
    ok = sum(1 for r in res if r.get("status") == "ok")
    skipped = sum(1 for r in res if r.get("status") == "skipped")
    print(f"\n=== dry-run: {ok} tallied, {skipped} skipped, "
          f"{out['failures']} failed in {out['seconds']:.1f} s ===")
    if out["failures"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

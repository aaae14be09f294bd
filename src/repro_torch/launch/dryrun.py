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

The dry-run on the production meshes (the reference's ``16x16`` and
``2x16x16`` pods) comes with ROADMAP queue 1, item 6c; every cell here is
one card, mesh ``h100x1``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from dataclasses import replace
from typing import Dict, Optional

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import (SHAPES, SHAPES_BY_NAME, ModelConfig,
                                      ShapeConfig, TrainConfig,
                                      cell_applicable)
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as sp
from repro_torch.launch.op_analysis import OpTally
from repro_torch.models import lm

MESH = "h100x1"
FIT_BASIS = ("argument bytes (params, Adam's moments, batch, caches): the "
             "temporaries of a step have no count without running it")


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
            with tally.repeat(len(ns)):
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
    with torch.no_grad():
        if shape.kind == "prefill":
            batch = sp.batch_specs(cfg, shape)
            caches = sp.cache_specs(cfg, B, S)
            extras = {k: batch[k] for k in ("frontend_embeds", "frames")
                      if k in batch}
            with tally:
                lm.prefill(model, batch["tokens"], caches, **extras)
        else:
            token, caches, cur = sp.decode_specs(cfg, shape)
            with tally:
                lm.decode_step(model, token, caches, cur)
    return tally


def run_cell(arch: str, shape_name: str, out_dir: Optional[str] = None,
             verbose: bool = True) -> Dict:
    """One cell: its JSON record (written to ``out_dir`` when given)."""
    cfg = registry.get(arch)
    shape = SHAPES_BY_NAME[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    result: Dict = {"arch": arch, "shape": shape_name, "mesh": MESH}
    if not ok:
        result.update(status="skipped", reason=reason)
        return _write(result, out_dir)

    t0 = time.monotonic()
    model = sp.abstract_model(cfg)
    args = argument_bytes(cfg, shape)
    if shape.kind == "train":
        mb = choose_microbatches(cfg, shape)
        tally = _tally_train(cfg, shape, mb, model)
        result["microbatches"] = mb
    else:
        if shape.kind == "prefill":
            result["prefill_chunks"] = 1
            if args["total"] > rl.HBM_BYTES and shape.global_batch % 2 == 0:
                # serving splits an oversized prefill batch over two calls;
                # the terms below are per call
                shape = ShapeConfig(shape.name, shape.seq_len,
                                    shape.global_batch // 2, shape.kind)
                result["batch_split"] = 2
                args = argument_bytes(cfg, shape)
        tally = _tally_serve(cfg, shape, model)
    tally_s = time.monotonic() - t0

    mf, tokens = sp.model_flops(cfg, shape)
    total, active = sp.param_counts(cfg)
    report = rl.RooflineReport(
        arch=arch, shape=shape_name, mesh=MESH, n_devices=1,
        flops_per_device=tally.flops, bytes_per_device=tally.bytes,
        argument_bytes=args["total"], model_flops=mf, params_total=total,
        params_active=active, tokens=tokens)
    result.update(report.to_dict())
    result.update(status="ok", tally_seconds=round(tally_s, 3),
                  argument_parts=args, fit_basis=FIT_BASIS,
                  tally=tally.to_dict(), card=rl.CARD)
    if verbose:
        print(f"[{arch} × {shape_name} × {MESH}] tallied in {tally_s:.1f}s")
        print(f"  arguments: {args['total'] / 1e9:.2f} GB "
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
        stop_on_error: bool = False) -> Dict:
    """Every cell of ``archs`` × ``shapes``; returns ``{"results",
    "failures", "seconds"}``."""
    t0 = time.monotonic()
    results, failures = [], 0
    for arch in archs:
        for shape in shapes:
            try:
                results.append(run_cell(arch, shape, out_dir, verbose))
            except Exception as e:
                failures += 1
                print(f"[FAIL {arch} × {shape} × {MESH}]: {e}")
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
    args = ap.parse_args(argv)
    archs = registry.names() if args.arch == "all" else args.arch.split(",")
    shapes = ([s.name for s in SHAPES] if args.shape == "all"
              else args.shape.split(","))
    out = run(archs, shapes, args.out, stop_on_error=args.stop_on_error)
    res = out["results"]
    ok = sum(1 for r in res if r.get("status") == "ok")
    skipped = sum(1 for r in res if r.get("status") == "skipped")
    print(f"\n=== dry-run: {ok} tallied, {skipped} skipped, "
          f"{out['failures']} failed in {out['seconds']:.1f} s ===")
    if out["failures"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

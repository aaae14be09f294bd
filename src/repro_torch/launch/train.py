"""Training entry point: the reference's ``repro.launch.train`` CLI on the
port.

    python -m repro_torch.launch.train --arch smollm-135m-butterfly-smoke \\
        --steps 200 --seq-len 128 --global-batch 8 --checkpoint-dir ckpt

It takes the reference's flags and prints its ``[train] ...`` start and
done lines, the run's execution context (``exec [...]``) included. It runs
on the card; ``--device cpu`` runs the plain PyTorch versions instead. A
``--checkpoint-dir`` that already holds a checkpoint, the port's or the
reference's, resumes from its newest step ("resumed from step N").

The reference's multi-device flags, one process a device
(:mod:`repro_torch.runtime.dist`):

* ``--mesh-shape 2`` (a ``("data",)`` mesh) or ``1x2`` (``("pod",
  "data")``) shards every butterfly site's rows over the mesh
  (:mod:`repro_torch.runtime.butterfly_sharding`); it needs a butterfly
  arch, and the world must have the mesh's ranks.
* ``--simulated-devices N`` starts N ranks on this host
  (:func:`~repro_torch.runtime.dist.spawn_ranks`): on the CPU over gloo
  with ``--device cpu``, else on the card, over gloo when they share it.
* ``--distributed`` joins the world ``torchrun`` describes
  (:func:`~repro_torch.runtime.dist.init_from_env`).

Every rank trains the same steps; rank 0 alone prints and writes
checkpoints. ``--xla-perf-flags`` exits, since XLA's flags have no torch
meaning. ``--arch`` takes every
registry name; the frontend archs' batches carry the reference trainer's
stub inputs (``frontend_embeds`` for internvl2-1b, ``frames`` for
seamless-m4t-medium; :class:`~repro_torch.train.trainer.Trainer`).

:func:`main` returns the :class:`~repro_torch.train.trainer.TrainResult`,
so that scripts and tests drive the CLI in process.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

__all__ = ["main", "with_mesh"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0], allow_abbrev=False)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup-steps", type=int, default=100)
    ap.add_argument("--weight-decay", type=float, default=0.1)
    ap.add_argument("--grad-compression", default="",
                    choices=["", "topk", "int8"])
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch versions)")
    ap.add_argument("--distributed", action="store_true",
                    help="join the world torchrun describes (RANK, "
                         "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT)")
    ap.add_argument("--xla-perf-flags", action="store_true",
                    help="XLA scheduler flags (no torch meaning)")
    ap.add_argument("--mesh-shape", default="",
                    help="butterfly data-parallel mesh, e.g. '2' for a "
                         "(data,) mesh or '1x2' for (pod, data); requires "
                         "a butterfly arch (rows sharded over the ranks)")
    ap.add_argument("--simulated-devices", type=int, default=0,
                    help="start N ranks on this host (must be >= the mesh "
                         "size): CPU ranks over gloo with --device cpu, "
                         "else ranks on the card")
    return ap


def with_mesh(cfg, args):
    """``cfg`` with ``--mesh-shape`` in its butterfly config; the
    reference's messages for a dense arch and a malformed shape."""
    if not args.mesh_shape:
        return cfg
    from dataclasses import replace as dc_replace
    if cfg.butterfly is None:
        raise SystemExit(
            f"--mesh-shape needs a butterfly arch (try "
            f"{args.arch}-butterfly); {cfg.name} has no butterfly sites")
    from repro_torch.launch.mesh import parse_mesh_shape
    shape = parse_mesh_shape(args.mesh_shape)
    return cfg.with_(butterfly=dc_replace(cfg.butterfly, mesh_shape=shape))


def main(argv: Optional[List[str]] = None):
    """Parse ``argv`` and train; returns rank 0's
    :class:`~repro_torch.train.trainer.TrainResult` (its mesh carried as
    its layout alone when it ran in a spawned rank)."""
    args = _parser().parse_args(argv)
    if args.xla_perf_flags:
        raise SystemExit("--xla-perf-flags sets XLA's TPU scheduler flags, "
                         "which have no torch meaning: the port runs eagerly "
                         "on the card")
    if args.simulated_devices < 0:
        raise SystemExit(f"--simulated-devices must be >= 1, got "
                         f"{args.simulated_devices}")
    if args.simulated_devices and args.distributed:
        raise SystemExit("--simulated-devices starts its own ranks; it "
                         "does not join a torchrun world (--distributed)")

    from repro_torch.kernels.context import resolve_device
    from repro_torch.launch import ported_config
    from repro_torch.runtime import dist as rdist

    cfg = with_mesh(ported_config(args.arch), args)
    device = resolve_device(args.device)
    if args.simulated_devices:
        return rdist.spawn_ranks(args.simulated_devices, _train, args, cfg,
                                 device=device.type)[0]
    if args.distributed:
        rdist.init_from_env(device.type)
        try:
            return _train(args, cfg)
        finally:
            rdist.shutdown()
    return _train(args, cfg, device)


def _train(args, cfg, device=None):
    """Train on this rank: ``device``, or the joined world's device. Rank 0
    prints the ``[train]`` lines; a rank outside the mesh trains nothing
    and returns ``None``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.runtime import dist as rdist
    from repro_torch.train.trainer import Trainer

    world = rdist.current_world()
    if world is not None:
        device = world.device
        where = f"{world.device.type}, {world.backend}"
    else:
        where = str(device)
    n = rdist.world_size()
    main_rank = rdist.rank() == 0
    tc = TrainConfig(
        learning_rate=args.lr, warmup_steps=args.warmup_steps,
        total_steps=args.steps, weight_decay=args.weight_decay,
        microbatches=args.microbatches, seed=args.seed,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        grad_compression=args.grad_compression)

    if main_rank:
        print(f"[train] {cfg.name} | {n} process(es), {n} device(s) "
              f"({where}) | steps={args.steps} seq={args.seq_len} "
              f"batch={args.global_batch} µb={args.microbatches}",
              flush=True)
    trainer = Trainer(cfg, tc, seq_len=args.seq_len,
                      global_batch=args.global_batch, device=device)
    if trainer.mesh is not None and trainer.mesh.coordinate is None:
        return None                 # a spare rank beyond the mesh
    result = trainer.run(args.steps)
    if main_rank:
        print(f"[train] done: loss {np.mean(result.losses[:5]):.4f} → "
              f"{np.mean(result.losses[-5:]):.4f}; "
              f"median step {np.median(result.step_times) * 1e3:.0f} ms"
              f"; exec [{result.execution.describe()}]"
              + (f"; resumed from step {result.resumed_from}"
                 if result.resumed_from else ""), flush=True)
    return result


if __name__ == "__main__":
    main()

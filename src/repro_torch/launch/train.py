"""Training entry point: the reference's ``repro.launch.train`` CLI on the
port.

    python -m repro_torch.launch.train --arch smollm-135m-butterfly-smoke \\
        --steps 200 --seq-len 128 --global-batch 8 --checkpoint-dir ckpt

It takes the reference's flags and prints its ``[train] ...`` start and
done lines, the run's execution context (``exec [...]``) included. It runs
on the card; ``--device cpu`` runs the plain PyTorch versions instead. A
``--checkpoint-dir`` that already holds a checkpoint, the port's or the
reference's, resumes from its newest step ("resumed from step N").

The reference's multi-device flags (``--mesh-shape``,
``--simulated-devices``, ``--distributed``) exit with a message naming
ROADMAP queue 1, item 6; ``--xla-perf-flags`` exits too, since XLA's flags
have no torch meaning. ``--arch`` takes every
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

__all__ = ["main"]


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
                    help="multi-host training (not ported)")
    ap.add_argument("--xla-perf-flags", action="store_true",
                    help="XLA scheduler flags (no torch meaning)")
    ap.add_argument("--mesh-shape", default="",
                    help="butterfly data-parallel mesh (not ported)")
    ap.add_argument("--simulated-devices", type=int, default=0,
                    help="simulated host devices (not ported)")
    return ap


def _refuse_unported(args) -> None:
    if args.mesh_shape or args.simulated_devices or args.distributed:
        raise SystemExit("--mesh-shape, --simulated-devices and "
                         "--distributed are not ported: the port trains on "
                         "one device (ROADMAP queue 1, item 6, brings "
                         "multi-device training)")
    if args.xla_perf_flags:
        raise SystemExit("--xla-perf-flags sets XLA's TPU scheduler flags, "
                         "which have no torch meaning: the port runs eagerly "
                         "on the card")


def main(argv: Optional[List[str]] = None):
    args = _parser().parse_args(argv)
    _refuse_unported(args)

    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels.context import resolve_device
    from repro_torch.launch import ported_config
    from repro_torch.train.trainer import Trainer

    cfg = ported_config(args.arch)
    device = resolve_device(args.device)
    tc = TrainConfig(
        learning_rate=args.lr, warmup_steps=args.warmup_steps,
        total_steps=args.steps, weight_decay=args.weight_decay,
        microbatches=args.microbatches, seed=args.seed,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        grad_compression=args.grad_compression)

    print(f"[train] {cfg.name} | 1 process(es), 1 device(s) ({device}) | "
          f"steps={args.steps} seq={args.seq_len} batch={args.global_batch} "
          f"µb={args.microbatches}", flush=True)
    trainer = Trainer(cfg, tc, seq_len=args.seq_len,
                      global_batch=args.global_batch, device=device)
    result = trainer.run(args.steps)
    print(f"[train] done: loss {np.mean(result.losses[:5]):.4f} → "
          f"{np.mean(result.losses[-5:]):.4f}; "
          f"median step {np.median(result.step_times) * 1e3:.0f} ms"
          f"; exec [{result.execution.describe()}]"
          + (f"; resumed from step {result.resumed_from}"
             if result.resumed_from else ""), flush=True)
    return result


if __name__ == "__main__":
    main()

"""End-to-end LM training, from the config registry to checkpoints.

Run: ``python -m repro_torch.examples.train_lm --arch smollm-135m-smoke
--steps 200 [--device cpu]``

Config registry -> synthetic data stream with prefetch -> microbatched
AdamW training -> async checkpoints -> resume. ``--butterfly`` swaps the LM
head and MLP for the paper's sandwich (§3.2/§5.1), trained through the
sandwich kernels on the card. A thin caller of the training entry point,
:mod:`repro_torch.launch.train`, with the example's sizes and a loss
curve.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional

import numpy as np

from repro_torch.launch import train as train_cli


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m-smoke")
    ap.add_argument("--butterfly", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)

    name = args.arch
    if args.butterfly:
        smoke = name.endswith("-smoke")
        base = name[:-6] if smoke else name
        name = base + "-butterfly" + ("-smoke" if smoke else "")
    ckpt = args.checkpoint_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    print(f"training {name}: {args.steps} steps, "
          f"seq={args.seq_len}, batch={args.global_batch} "
          f"(checkpoints → {ckpt})")
    cli = ["--arch", name, "--steps", str(args.steps),
           "--seq-len", str(args.seq_len),
           "--global-batch", str(args.global_batch),
           "--microbatches", str(args.microbatches), "--lr", str(args.lr),
           "--warmup-steps", "20",
           "--checkpoint-every", str(max(args.steps // 4, 1)),
           "--checkpoint-dir", ckpt]
    if args.device:
        cli += ["--device", args.device]
    res = train_cli.main(cli)
    w = max(len(res.losses) // 10, 1)
    for i in range(0, len(res.losses), w):
        print(f"  step {i:4d}: loss {np.mean(res.losses[i:i + w]):.4f}")
    print(f"final loss: {np.mean(res.losses[-5:]):.4f} "
          f"(from {np.mean(res.losses[:5]):.4f}); "
          f"median step time {np.median(res.step_times) * 1e3:.0f} ms")
    print("re-run with the same --checkpoint-dir to resume from the last "
          "checkpoint.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

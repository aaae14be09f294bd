"""Entry point of the paper's remaining experiments: parameter counts, the
gated butterfly, the learned sketch and the butterfly LM head.

    python -m repro_torch.launch.paper [--device cpu] [--quick]
        [--only params|nonlinear|sketch|sketch_ell|lm_butterfly]
        [--steps S] [--n N --d D --ell L --k K] [--out FILE]

Prints the rows of the reference's ``benchmarks/bench_param_counts.py``,
``bench_nonlinear.py``, ``bench_sketch.py`` (``run`` and
``run_ell_sweep``) and ``bench_lm_butterfly.py`` under the same names and
``derived`` fields, as the reference's ``name,us_per_call,derived`` lines
(``us_per_call`` 0.00: these rows time nothing):

* ``params/{layer}``: dense against sandwich parameters at the paper's
  layer sizes and four LM heads (``k = log2 n``);
* ``nonlinear/{linear,mlp}_target``: Adam fits of a linear butterfly
  (through the butterfly kernels) and a gated one (plain PyTorch) to a
  linear and a 2-layer-MLP target, n 64, batch 512;
* ``sketch/{hyper_like,cifar_like}_l{ell}_k{k}``: the five sketches' test
  errors; ``sketch_ell/l{8,16,32}_k{k}``: butterfly against sparse over ℓ;
* ``lm_butterfly/final_loss``: the port's ``Trainer`` on
  ``smollm-135m-smoke`` and ``smollm-135m-butterfly-smoke``, seq_len 64,
  batch 8, and their parameter counts.

Steps default to the reference's (nonlinear 300, sketch 120, the ℓ sweep
80, lm_butterfly 60); ``--quick`` takes ``benchmarks/run.py``'s quick steps
(nonlinear 120, sketch and the sweep 30, lm_butterfly 15) and ``--steps``
sets every section's. ``--n/--d/--ell/--k`` run the sketch rows at another
shape (``--ell`` alone in the sweep). Draws come from ``torch.Generator``s
seeded as the reference seeds its keys, so the numbers are the
experiment's, not the reference's bits. The device defaults to the card;
float32 products run in full float32 (TF32 off, checked).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.core import butterfly as bf
from repro_torch.core import layers as bl
from repro_torch.core import sketch
from repro_torch.data.synthetic import sketch_datasets
from repro_torch.kernels import butterfly as kb
from repro_torch.kernels.context import ContextLike, resolve_device
from repro_torch.launch.encdec import full_float32
from repro_torch.launch.speed import line
from repro_torch.optim import optimizer as opt
from repro_torch.train.trainer import Trainer

SECTIONS = ("params", "nonlinear", "sketch", "sketch_ell", "lm_butterfly")
FULL_STEPS = {"nonlinear": 300, "sketch": 120, "sketch_ell": 80,
              "lm_butterfly": 60}
QUICK_STEPS = {"nonlinear": 120, "sketch": 30, "sketch_ell": 30,
               "lm_butterfly": 15}
# (model, n1, n2): the final dense layers of the paper's Table 1 models
PAPER_LAYERS = [
    ("efficientnet-b0", 1280, 10),
    ("preactresnet18", 512, 10),
    ("seresnet152", 2048, 100),
    ("senet154", 2048, 1000),
    ("flair-tagger-en", 4096, 20),
    ("flair-tagger-pos", 4096, 50),
]
# LM heads of the reference's architectures (d_model -> vocab)
LM_HEADS = [
    ("smollm-135m-head", 576, 49152),
    ("gemma3-27b-head", 5376, 262144),
    ("mistral-large-head", 12288, 32768),
    ("olmoe-head", 2048, 50304),
]
LM_VARIANTS = ("smollm-135m-smoke", "smollm-135m-butterfly-smoke")
LM_SEQ_LEN, LM_BATCH = 64, 8
NONLINEAR_N, NONLINEAR_BATCH, NONLINEAR_LR = 64, 512, 3e-3
SKETCH_SHAPE = (64, 48, 16, 8)          # n, d, ell, k of bench_sketch.py
SKETCH_ELLS = (8, 16, 32)
SKETCH_LR, SKETCH_BATCH = 3e-3, 6


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _row(name: str, derived: str, **fields) -> Dict:
    return dict(name=name, us_per_call=0.0, derived=derived, **fields)


def param_rows() -> List[Dict]:
    rows = []
    for name, n1, n2 in PAPER_LAYERS + LM_HEADS:
        dense = bl.dense_param_count(n1, n2)
        spec = bl.make_spec(_gen(0), n1, n2)        # the paper's log2(n)
        ours, eff = bl.param_count(spec), bl.effective_param_count(spec)
        rows.append(_row(
            f"params/{name}",
            f"dense={dense};butterfly={ours};effective={eff};"
            f"reduction={dense / max(ours, 1):.1f}x",
            dense=dense, butterfly=ours, effective=eff))
    return rows


# -- the gated butterfly (paper §7) ------------------------------------------

def linear_arm(w: torch.Tensor, X: torch.Tensor, context: ContextLike = None
               ) -> torch.Tensor:
    """The linear butterfly through the butterfly kernels."""
    return kb.butterfly_apply(X, w, context=context)


def mse(apply_fn, w: torch.Tensor, X: torch.Tensor, Y: torch.Tensor
        ) -> torch.Tensor:
    return torch.mean(torch.square(apply_fn(w, X) - Y))


def fit(apply_fn, w0: torch.Tensor, X: torch.Tensor, Y: torch.Tensor,
        steps: int) -> float:
    """Adam (no decay, NONLINEAR_LR) on the mean squared error from
    ``w0``; returns the final loss."""
    w = w0.detach().clone()
    opt.fit(lambda: mse(apply_fn, w, X, Y), {"w": w}, steps, NONLINEAR_LR)
    with torch.no_grad():
        return float(mse(apply_fn, w, X, Y))


def nonlinear_problem(dev) -> tuple:
    """The bench's inputs ``X`` (batch, n), its targets ``{name: Y}`` and
    the FJLT start ``w0`` of both arms."""
    n, batch = NONLINEAR_N, NONLINEAR_BATCH
    X = torch.randn(batch, n, generator=_gen(0)).to(dev)
    W = (torch.randn(n, n, generator=_gen(1)) / math.sqrt(n)).to(dev)
    W1 = (torch.randn(n, 2 * n, generator=_gen(2)) / math.sqrt(n)).to(dev)
    W2 = (torch.randn(2 * n, n, generator=_gen(3))
          / math.sqrt(2 * n)).to(dev)
    targets = {"linear_target": X @ W.T,
               "mlp_target": bf.tanh_gelu(X @ W1) @ W2}
    return X, targets, bf.fjlt_weights(_gen(4), n).to(dev)


def nonlinear_rows(dev, steps: int) -> List[Dict]:
    X, targets, w0 = nonlinear_problem(dev)
    rows = []
    for name, Y in targets.items():
        var_y = float(torch.var(Y, correction=0))
        l_lin = fit(linear_arm, w0, X, Y, steps)
        l_gated = fit(bf.butterfly_apply_nonlinear, w0, X, Y, steps)
        rows.append(_row(
            f"nonlinear/{name}",
            f"linear_butterfly={l_lin:.4f};gated_butterfly={l_gated:.4f};"
            f"target_var={var_y:.4f}",
            linear_butterfly=l_lin, gated_butterfly=l_gated,
            target_var=var_y))
    return rows


# -- the learned sketch (paper §6) -------------------------------------------

def sketch_errors(train: torch.Tensor, test: torch.Tensor, ell: int, k: int,
                  steps: int, seed: int = 0, dense: bool = True,
                  log_every: int = 0, step_times: Optional[list] = None
                  ) -> Dict:
    """The test errors of the learned butterfly (spec from ``seed``, FJLT
    start from ``seed + 1``), the learned sparse sketch (``seed + 2``), the
    random CW (``seed + 3``) and Gaussian (``seed + 4``) sketches and, with
    ``dense``, the learned dense-N one (``seed + 5``): the bench's keys.
    Each trains at the bench's SKETCH_LR and SKETCH_BATCH. Also returns the
    butterfly's ``spec``, start ``w0``, learned ``w`` and logged losses
    ``history``; ``step_times`` collects the butterfly's training steps'
    seconds."""
    dev = train.device
    n = train.shape[1]
    spec = sketch.make_spec(_gen(seed), n=n, ell=ell, k=k)
    w0 = bf.fjlt_weights(_gen(seed + 1), spec.pad_n).to(dev)
    w, history = sketch.train_butterfly_sketch(
        spec, None, train, steps, lr=SKETCH_LR, batch=SKETCH_BATCH,
        log_every=log_every, w0=w0, device=dev, step_times=step_times)
    out = {"spec": spec, "w0": w0, "w": w, "history": history}
    out["butterfly_learned"] = sketch.test_error(
        lambda X: sketch.butterfly_sketch(spec, w, X), test, k)
    rows, values, _ = sketch.train_sparse_sketch(
        _gen(seed + 2), train, n=n, ell=ell, k=k, steps=steps, lr=SKETCH_LR,
        batch=SKETCH_BATCH, device=dev)
    Bs = sketch.sparse_sketch_matrix(rows, values, ell)
    out["sparse_learned"] = sketch.test_error(lambda X: Bs @ X, test, k)
    rows0, signs0 = sketch.cw_pattern(_gen(seed + 3), n, ell)
    B0 = sketch.sparse_sketch_matrix(rows0, torch.from_numpy(signs0).to(dev),
                                     ell)
    out["cw_random"] = sketch.test_error(lambda X: B0 @ X, test, k)
    G = sketch.gaussian_sketch(_gen(seed + 4), n, ell, device=dev)
    out["gaussian"] = sketch.test_error(lambda X: G @ X, test, k)
    if dense:
        rowsN, valuesN, _ = sketch.train_sparse_sketch(
            _gen(seed + 5), train, n=n, ell=ell, k=k, steps=steps,
            lr=SKETCH_LR, nnz_per_col=ell, batch=SKETCH_BATCH, device=dev)
        BN = sketch.sparse_sketch_matrix(rowsN, valuesN, ell)
        out["dense_learned"] = sketch.test_error(lambda X: BN @ X, test, k)
    return out


def _split(Xs, t_train: int, dev):
    X = torch.from_numpy(np.stack(Xs)).to(dev)
    return X[:t_train], X[t_train:]


def sketch_rows(dev, steps: int, n: int, d: int, ell: int, k: int
                ) -> List[Dict]:
    data, t_train = sketch_datasets(n, d)
    rows = []
    for name, Xs in data.items():
        e = sketch_errors(*_split(Xs, t_train, dev), ell, k, steps)
        keys = ("butterfly_learned", "sparse_learned", "cw_random",
                "gaussian")
        rows.append(_row(
            f"sketch/{name}_l{ell}_k{k}",
            "".join(f"{key}={e[key]:.4f};" for key in keys)
            + f"dense_learned_N{ell}={e['dense_learned']:.4f}",
            **{key: e[key] for key in keys + ("dense_learned",)}))
    return rows


def sketch_ell_rows(dev, steps: int, n: int, d: int, ells, k: int
                    ) -> List[Dict]:
    """Figure 17: error against ℓ at ``k`` on ``hyper_like``."""
    data, t_train = sketch_datasets(n, d)
    train, test = _split(data["hyper_like"], t_train, dev)
    rows = []
    for ell in ells:
        e = sketch_errors(train, test, ell, k, steps, seed=ell, dense=False)
        rows.append(_row(
            f"sketch_ell/l{ell}_k{k}",
            f"butterfly_learned={e['butterfly_learned']:.4f};"
            f"sparse_learned={e['sparse_learned']:.4f}",
            butterfly_learned=e["butterfly_learned"],
            sparse_learned=e["sparse_learned"]))
    return rows


# -- the butterfly LM head (§5.1 at framework scale) -------------------------

def lm_butterfly_row(dev, steps: int) -> Dict:
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=steps)
    res = {}
    for variant in LM_VARIANTS:
        tr = Trainer(registry.get(variant), tc, seq_len=LM_SEQ_LEN,
                     global_batch=LM_BATCH, device=dev)
        losses = tr.run(steps).losses
        res[variant] = (float(np.mean(losses[-5:])),
                        sum(p.numel() for p in tr.model.parameters()),
                        losses)
    (d_loss, d_n, d_all), (b_loss, b_n, b_all) = (res[v] for v in
                                                  LM_VARIANTS)
    return _row("lm_butterfly/final_loss",
                f"dense={d_loss:.4f};butterfly={b_loss:.4f};"
                f"dense_params={d_n};butterfly_params={b_n}",
                dense=d_loss, butterfly=b_loss, dense_params=d_n,
                butterfly_params=b_n, dense_losses=d_all,
                butterfly_losses=b_all)


def run(dev, *, sections=SECTIONS, steps: Optional[Dict] = None,
        shape=SKETCH_SHAPE, ells=SKETCH_ELLS) -> List[Dict]:
    """The rows of ``sections`` on ``dev``; ``steps`` per section default
    to the reference's, ``shape`` is the sketch rows' (n, d, ell, k) and
    ``ells`` the sweep's ℓs."""
    steps = dict(FULL_STEPS, **(steps or {}))
    n, d, ell, k = shape
    rows: List[Dict] = []
    if "params" in sections:
        rows += param_rows()
    if "nonlinear" in sections:
        rows += nonlinear_rows(dev, steps["nonlinear"])
    if "sketch" in sections:
        rows += sketch_rows(dev, steps["sketch"], n, d, ell, k)
    if "sketch_ell" in sections:
        rows += sketch_ell_rows(dev, steps["sketch_ell"], n, d, ells, k)
    if "lm_butterfly" in sections:
        rows.append(lm_butterfly_row(dev, steps["lm_butterfly"]))
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--only", choices=SECTIONS, action="append",
                    help="run only this section (repeatable)")
    ap.add_argument("--quick", action="store_true",
                    help="benchmarks/run.py --quick's steps")
    ap.add_argument("--steps", type=int, default=None,
                    help="Adam/train steps of every section")
    ap.add_argument("--n", type=int, default=SKETCH_SHAPE[0])
    ap.add_argument("--d", type=int, default=SKETCH_SHAPE[1])
    ap.add_argument("--ell", type=int, default=None,
                    help=f"sketch rows (default {SKETCH_SHAPE[2]}); alone "
                         f"in the sweep (default {SKETCH_ELLS})")
    ap.add_argument("--k", type=int, default=SKETCH_SHAPE[3])
    ap.add_argument("--out", default=None,
                    help="also write the rows here as JSON")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    full_float32()
    steps = dict(QUICK_STEPS) if args.quick else {}
    if args.steps is not None:
        steps = {key: args.steps for key in FULL_STEPS}
    ell = SKETCH_SHAPE[2] if args.ell is None else args.ell
    ells = SKETCH_ELLS if args.ell is None else (args.ell,)
    sys.stdout.write("name,us_per_call,derived\n")
    rows = run(dev, sections=tuple(args.only or SECTIONS), steps=steps,
               shape=(args.n, args.d, ell, args.k), ells=ells)
    for r in rows:
        sys.stdout.write(line(r) + "\n")
    if args.out:
        device = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                  else "cpu")
        with open(args.out, "w") as f:
            json.dump({"device": device, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

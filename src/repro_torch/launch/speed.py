"""Entry point of the kernel and speed benchmarks.

    python -m repro_torch.launch.speed [--device cpu]
        [--only kernel|speed|backward] [--ns N ...] [--batch B]
        [--iters I] [--out FILE]

Prints the rows of the reference's ``benchmarks/bench_kernels.py``,
``bench_speed.py`` and ``bench_backward.py`` under the same names and
``derived`` fields, one ``name,us_per_call,derived`` line each, after a
``name,us_per_call,derived`` header:

* ``kernel/butterfly_n{n}``: the butterfly product ``B x`` at B = 128
  rows, with the dense ``x Wᵀ`` beside it and the reference's FLOP and byte
  ratios;
* ``speed/forward_n{n}``, ``speed/train_n{n}``: the paper's Figures 12/13,
  a dense layer against its butterfly replacement (the sandwich), forward
  and an SGD train step, at B = 64;
* ``backward/{butterfly,sandwich,flash}_fwdbwd_{jnp,fused}_n{n}``: a
  value-and-grad step (input and weight cotangents) at batch 64, flash at
  B = 1, H = 2, D = 64, causal, float32.

A row's value is the median µs of one synchronised call, after 3 warm
calls, over the reference bench's own iterations: 20, and in
``bench_backward`` 20 at n <= 2048 and 5 above (``--iters`` overrides
them). Each ``*_jnp_*`` row runs the port's plain versions
(``impl=plain``); each ``*_fused_*`` row the kernels through
``ButterflyFn``, ``SandwichFn`` or ``FlashFn`` and gains
``speedup_vs_plain``. ``kernel/*`` and ``speed/*`` rows run the route the
device picks: the kernels on the card (``impl=cuda``, with ``plain_us``
and ``speedup_vs_plain``), the plain versions on the CPU
(``impl=plain``). On the CPU the fused rows are skipped (``no_cuda``), and
the plain flash row above S = 4096 as the reference skips it
(``cpu_quadratic_oracle_guard``). The reference's
``block_b``/``segment``/``block_q``/``block_kv`` fields name its TPU tiles;
here they name the port's kernels' own (``block_q``/``block_kv`` as the
built flash library reports them, so on the card only).

Inputs come from ``torch.Generator`` seeds; the device defaults to the
card, with float32 products in full float32 (TF32 off, checked). ``--out``
writes the rows as JSON; ``BENCH_quick.json`` is the reference's and is
never written here.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core import butterfly as bf
from repro_torch.core import layers as blayers
from repro_torch.kernels import butterfly as kb
from repro_torch.kernels import flash as kf
from repro_torch.kernels import sandwich as ks
from repro_torch.kernels.context import resolve_device
from repro_torch.launch.encdec import full_float32
from repro_torch.nn import ButterflyLinear

KERNEL_NS, KERNEL_B = (256, 1024, 4096), 128
SPEED_NS, SPEED_B = (512, 1024, 2048, 4096), 64
BACKWARD_NS, BACKWARD_BATCH = (1024, 4096, 8192), 64
FLASH_B, FLASH_HEADS, FLASH_DIM = 1, 2, 64
WARMUP = 3
NO_CUDA = "no_cuda"
CPU_GUARD = "cpu_quadratic_oracle_guard"
BENCHES = ("kernel", "speed", "backward")


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _randn(seed: int, *shape, dev) -> torch.Tensor:
    return torch.randn(*shape, generator=_gen(seed)).to(dev)


def time_fn(fn: Callable, dev: torch.device, iters: int = 20,
            warmup: int = WARMUP) -> float:
    """Median µs of one call, each synchronised (``benchmarks/common.py``
    ``time_fn``)."""

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e6)
    return float(statistics.median(times))


def row(name: str, us: float, derived: str, calls: int) -> Dict:
    """A timed row; ``calls`` counts the timed function's calls, warm ones
    included."""
    return {"name": name, "us_per_call": us, "derived": derived,
            "calls": calls}


def skipped(name: str, reason: str, derived: str = "") -> Dict:
    """A row not measured, with its reason (``emit_skipped``)."""
    extra = f"status=skipped;reason={reason}"
    return {"name": name, "us_per_call": None, "skipped": True,
            "derived": f"{extra};{derived}" if derived else extra,
            "calls": 0}


def line(r: Dict) -> str:
    """The reference's CSV line of a row."""
    us = "" if r["us_per_call"] is None else f"{r['us_per_call']:.2f}"
    return f"{r['name']},{us},{r['derived']}"


class Bench:
    """Timing on one device: ``iters`` overrides every bench's own. With a
    ``checks`` list, each timed kernel row appends ``(name, op, make)``:
    ``make(backend)`` gives a call on that row's inputs that returns its
    output and, for a step, its gradients, so that the kernels can be held
    against the plain versions after the timed run."""

    def __init__(self, dev: torch.device, iters: Optional[int] = None,
                 checks: Optional[List] = None):
        self.dev, self.iters, self.checks = dev, iters, checks
        self.on_card = dev.type == "cuda"

    def check(self, name: str, op: str, make: Callable[[str], Callable]):
        if self.checks is not None:
            self.checks.append((name, op, make))

    def time(self, fn: Callable, iters: int) -> tuple:
        """(median µs, calls)."""
        it = self.iters if self.iters is not None else iters
        return time_fn(fn, self.dev, it), WARMUP + it

    def routed(self, name: str, op: str, fn: Callable[[str], Callable],
               derived: str, iters: int,
               check: Optional[Callable[[str], Callable]] = None) -> Dict:
        """A ``kernel/*`` or ``speed/*`` row: the route the device picks,
        and on the card the plain version beside it. ``check`` (default
        ``fn``) is what :meth:`check` records."""
        self.check(name, op, check or fn)
        us, calls = self.time(fn("auto"), iters)
        if not self.on_card:
            return row(name, us, f"{derived};impl=plain", calls)
        plain, _ = self.time(fn("torch"), iters)
        return row(name, us, f"{derived};impl=cuda;plain_us={plain:.1f};"
                   f"speedup_vs_plain={plain / us:.2f}x", calls)

    def pair(self, name: str, op: str, step: Callable[..., Callable],
             iters: int, derived: str, tiles: Callable[[], str],
             plain_ok: bool = True) -> List[Dict]:
        """The ``*_jnp_*`` row (plain) and the ``*_fused_*`` row (the
        kernels) of one ``backward/*`` step; ``tiles()`` names the kernels'
        tiles."""
        jnp_name = name.replace("{impl}", "jnp")
        fused_name = name.replace("{impl}", "fused")
        rows, plain = [], None
        if plain_ok or self.on_card:
            plain, calls = self.time(step("torch"), iters)
            rows.append(row(jnp_name, plain, f"{derived};impl=plain", calls))
        else:
            rows.append(skipped(jnp_name, CPU_GUARD, derived))
        self.check(fused_name, op,
                   lambda backend: step(backend, with_out=True))
        if not self.on_card:
            rows.append(skipped(fused_name, NO_CUDA, tiles()))
            return rows
        us, calls = self.time(step("cuda"), iters)
        rows.append(row(fused_name, us, f"{derived};{tiles()};"
                        f"speedup_vs_plain={plain / us:.2f}x", calls))
        return rows


# -- bench_kernels ------------------------------------------------------------

def butterfly_forward(x, w, backend: str) -> Callable:
    """``B x`` through ``backend``."""
    return lambda: kb.butterfly_forward(x, w, backend=backend)


def kernel_rows(bench: Bench, ns: Sequence[int] = KERNEL_NS,
                B: int = KERNEL_B) -> List[Dict]:
    dev, rows = bench.dev, []
    for n in ns:
        w = bf.fjlt_weights(_gen(0), n).to(dev)
        x = _randn(1, B, n, dev=dev)
        W = _randn(2, n, n, dev=dev) / math.sqrt(n)
        bfly = functools.partial(butterfly_forward, x, w)
        with torch.no_grad():
            dense_us, _ = bench.time(lambda: x @ W.T, 20)
            p = bf.num_stages(n)
            flops_bfly = 4 * n * p * B
            flops_dense = 2 * n * n * B
            bytes_bfly = (2 * B * n + 2 * n * p) * 4
            bytes_dense = (2 * B * n + n * n) * 4
            rows.append(bench.routed(
                f"kernel/butterfly_n{n}", "butterfly", bfly,
                f"dense_us={dense_us:.1f};"
                f"flop_ratio={flops_dense / flops_bfly:.1f}x;"
                f"byte_ratio={bytes_dense / bytes_bfly:.1f}x;"
                f"arith_intensity={flops_bfly / bytes_bfly:.2f}", 20))
    return rows


# -- bench_speed --------------------------------------------------------------

def layer_forward(layer, x, backend: str) -> Callable:
    """The butterfly layer's forward through ``backend``."""
    return lambda: layer(x, backend=backend)


def layer_grads(layer, x, y, backend: str) -> Callable:
    """The layer's output and the gradients of the squared error to ``y``
    w.r.t. its weights, through ``backend``."""
    params = list(layer.parameters())

    def grads():
        out = layer(x, backend=backend)
        return (out.detach(),
                *torch.autograd.grad(((out - y) ** 2).mean(), params))
    return grads


def layer_step(layer, x, y, backend: str) -> Callable:
    """One SGD step (lr 0.1) of the layer on the squared error to ``y``."""
    params, grads = list(layer.parameters()), layer_grads(layer, x, y,
                                                          backend)

    def step():
        _, *g = grads()
        return [p - 0.1 * gp for p, gp in zip(params, g)]
    return step


def speed_rows(bench: Bench, ns: Sequence[int] = SPEED_NS,
               B: int = SPEED_B) -> List[Dict]:
    dev, rows = bench.dev, []
    for n in ns:
        W = _randn(0, n, n, dev=dev) / math.sqrt(n)
        x = _randn(1, B, n, dev=dev)
        spec = blayers.make_spec(_gen(2), n, n, use_bias=False)
        layer = ButterflyLinear(spec, generator=_gen(3)).to(dev)
        with torch.no_grad():
            dense_us, _ = bench.time(lambda: x @ W.T, 20)
            fwd = bench.routed(f"speed/forward_n{n}", "sandwich",
                               functools.partial(layer_forward, layer, x), "",
                               20)
        fwd["derived"] = (f"dense_us={dense_us:.1f};speedup="
                          f"{dense_us / fwd['us_per_call']:.2f}x"
                          + fwd["derived"])
        rows.append(fwd)

        y = _randn(4, B, n, dev=dev)

        def dense_step():
            Wg = W.detach().requires_grad_()
            (g,) = torch.autograd.grad(((x @ Wg.T - y) ** 2).mean(), Wg)
            return W - 0.1 * g

        dense_t, _ = bench.time(dense_step, 20)
        train = bench.routed(f"speed/train_n{n}", "sandwich",
                             functools.partial(layer_step, layer, x, y), "",
                             20, functools.partial(layer_grads, layer, x, y))
        train["derived"] = (f"dense_us={dense_t:.1f};speedup="
                            f"{dense_t / train['us_per_call']:.2f}x"
                            + train["derived"])
        rows.append(train)
    return rows


# -- bench_backward -----------------------------------------------------------

def _vdot(c: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return (c * out).sum()


def _grads(c, fn, inputs, with_out: bool):
    """``grad`` of ``vdot(c, fn(*leaves))`` w.r.t. fresh leaves of
    ``inputs``, after the output when ``with_out``."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    grads = torch.autograd.grad(_vdot(c, out), leaves)
    return (out.detach(), *grads) if with_out else grads


def butterfly_step(x, w, c, backend: str, with_out: bool = False
                   ) -> Callable:
    """``grad`` of ``vdot(c, butterfly_apply(x, w))`` w.r.t. (x, w), after
    the output when ``with_out``."""
    return lambda: _grads(
        c, lambda xg, wg: kb.butterfly_apply(xg, wg, backend=backend),
        (x, w), with_out)


def sandwich_step(x, b_in, core, b_out, idx_in, idx_out, c, scale: float,
                  backend: str, with_out: bool = False) -> Callable:
    """``grad`` of ``vdot(c, sandwich(x))`` w.r.t. (x, b_in, core, b_out),
    the bench's square n -> n sandwich with ``scale_in = scale_out =
    scale``, after the output when ``with_out``."""
    n = x.shape[-1]
    return lambda: _grads(
        c, lambda *leaves: ks.sandwich_forward(
            *leaves, idx_in, idx_out, scale_in=scale, scale_out=scale,
            n_out=n, backend=backend), (x, b_in, core, b_out), with_out)


def flash_step(q, k, v, c, backend: str, with_out: bool = False,
               causal: bool = True) -> Callable:
    """``grad`` of ``vdot(c, flash_attention(q, k, v))`` w.r.t. q, k, v,
    after the output when ``with_out``."""
    return lambda: _grads(
        c, lambda *leaves: kf.flash_attention(*leaves, causal=causal,
                                              backend=backend),
        (q, k, v), with_out)


def backward_rows(bench: Bench, ns: Sequence[int] = BACKWARD_NS,
                  batch: int = BACKWARD_BATCH) -> List[Dict]:
    dev, rows = bench.dev, []

    def flash_tiles():
        if not bench.on_card:     # the library that reports them is not built
            return ""
        return "block_q={0};block_kv={0}".format(kf.tile_rows(FLASH_DIM))

    for n in ns:
        it = 20 if n <= 2048 else 5
        p = bf.num_stages(n)
        tiles = f"block_b=1;segment={kb.default_segment(p)}"

        w = bf.random_weights(_gen(0), n).to(dev)
        x, c = _randn(1, batch, n, dev=dev), _randn(2, batch, n, dev=dev)
        rows += bench.pair(
            f"backward/butterfly_fwdbwd_{{impl}}_n{n}", "butterfly",
            functools.partial(butterfly_step, x, w, c), it,
            f"batch={batch}", lambda: tiles)

        k = max(2, int(math.log2(n)))
        spec = blayers.make_spec(_gen(3), n, n, k_in=k, k_out=k,
                                 use_bias=False)
        layer = ButterflyLinear(spec, generator=_gen(4)).to(dev)
        xs, cs = _randn(5, batch, n, dev=dev), _randn(6, batch, n, dev=dev)
        args = (xs, layer.b_in, layer.core, layer.b_out, layer.idx_in,
                layer.idx_out, cs, math.sqrt(n / k))
        rows += bench.pair(
            f"backward/sandwich_fwdbwd_{{impl}}_n{n}", "sandwich",
            functools.partial(sandwich_step, *args), it,
            f"batch={batch};k={k}", lambda: tiles)

        shape = (FLASH_B, FLASH_HEADS, n, FLASH_DIM)
        q, kk, v, cf = (_randn(7 + i, *shape, dev=dev) for i in range(4))
        rows += bench.pair(
            f"backward/flash_fwdbwd_{{impl}}_n{n}", "flash",
            functools.partial(flash_step, q, kk, v, cf), it,
            f"heads={FLASH_HEADS};head_dim={FLASH_DIM}",
            flash_tiles, plain_ok=n <= 4096)
    return rows


def run(dev: torch.device, *, only: Sequence[str] = BENCHES,
        ns: Optional[Sequence[int]] = None, batch: Optional[int] = None,
        iters: Optional[int] = None, checks: Optional[List] = None
        ) -> List[Dict]:
    """The rows of the benches in ``only``, at their own sizes unless
    ``ns`` (every bench's n) or ``batch`` (every bench's rows) is given;
    ``checks`` as :class:`Bench` takes it."""
    bench = Bench(dev, iters, checks)
    rows = []
    if "kernel" in only:
        rows += kernel_rows(bench, ns or KERNEL_NS, batch or KERNEL_B)
    if "speed" in only:
        rows += speed_rows(bench, ns or SPEED_NS, batch or SPEED_B)
    if "backward" in only:
        rows += backward_rows(bench, ns or BACKWARD_NS,
                              batch or BACKWARD_BATCH)
    return rows


def row_names(only: Sequence[str] = BENCHES,
              ns: Optional[Sequence[int]] = None) -> List[str]:
    """Every row name the reference benches print for these sizes."""
    names = []
    if "kernel" in only:
        names += [f"kernel/butterfly_n{n}" for n in ns or KERNEL_NS]
    if "speed" in only:
        names += [f"speed/{kind}_n{n}" for n in ns or SPEED_NS
                  for kind in ("forward", "train")]
    if "backward" in only:
        names += [f"backward/{op}_fwdbwd_{impl}_n{n}"
                  for n in ns or BACKWARD_NS
                  for op in ("butterfly", "sandwich", "flash")
                  for impl in ("jnp", "fused")]
    return names


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions and skips the fused rows)")
    ap.add_argument("--only", choices=BENCHES, action="append",
                    help="run only this bench (repeatable)")
    ap.add_argument("--ns", type=int, nargs="+", default=None,
                    help="sizes n of every bench (default: each bench's "
                         "own)")
    ap.add_argument("--batch", type=int, default=None,
                    help="rows of every bench (default: each bench's own)")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed calls per row (default: each bench's own)")
    ap.add_argument("--out", default=None, help="also write the rows here "
                    "as JSON")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    full_float32()
    only = tuple(args.only or BENCHES)
    sys.stdout.write("name,us_per_call,derived\n")
    rows = run(dev, only=only, ns=args.ns, batch=args.batch,
               iters=args.iters)
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

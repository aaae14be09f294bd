#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU, end to end.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.

1. Device: the card's name, count and power limit.
2. Build: the seven CUDA libraries from ``src/repro_torch/csrc`` (one
   ``nvcc`` each, in parallel), with their ``-Xptxas -v`` register,
   shared-memory and spill lines.
3. Sandwich forward (two kernels: the truncated factors, then the row
   products) vs its plain twins at the three full-width sites of
   ``smollm-135m-butterfly`` (up/gate 576->1536, down 1536->576, lm_head
   576->49152) and the widest output the kernels take (32->262144): the
   factor kernel against ``sandwich_factors_plain`` within 1e-5, and the
   whole forward against the stage-by-stage ``sandwich_plain`` at 8, 8x4
   (the verify pass of ``spec_k`` 3), 8x16 and the training run's 8192 rows, float32 at 2e-4 and bfloat16 at 5e-2.
4. Paged decode kernels (the split over runs of 4 pages, then the
   combine) vs their plain twin: 8 slots, 3 KV heads, 3 query heads per
   group, head dim 64, pages of 16, at the serving engine's 512 positions
   and at a long 2048 (7,883 live positions), with a dirty trash page,
   stale rows and NaN pages past ``cur_pos``; float32 at 1e-5 and bfloat16
   at 2e-2; two launches bit-identical.
5. Sandwich backward (six kernels: the factors again, the row products,
   the column products, their sum over row splits, the factor-row VJP, the
   reduction) vs its plain
   twin at the three sites, at 256 rows and at the training run's 8192 (the
   head at 2048: the plain twin's memory), and at ``bench_backward``'s 8192
   -> 8192 sandwich (k = 13, 64 rows), float32 at 1e-5 and bfloat16 at 8%
   of max|want|; two launches bit-identical. The factor-row VJP alone vs
   its twin (autograd through the plain factors) at each site, float32 at
   1e-5 of max|want|, two launches bit-identical.
5a. Widths past the smollm sites: the sandwich forward and backward at
   mistral-large-123b's ``down`` site (28,672 -> 12,288, n1 = 32,768, n2 =
   16,384, k = log2 n) at 64 rows, float32 and bfloat16, against the plain
   twins at the tolerances above.
6. Serving: a ServeEngine on full-width ``smollm-135m-butterfly``
   (random weights from seed 0, bfloat16 compute, 8 slots, max_len 512,
   prefill chunks of 16, greedy) serves 16 requests with prompts of 5 to
   200 tokens and 32 new tokens each, every decode and chunk tick the
   replay of a CUDA graph captured once per key (the key's first tick is
   its warm-up, run eagerly, then the capture). Checks: every request gets
   its 32 tokens, the kernels' launch counters rose by 2 x 91 (sandwich:
   factors and rows) and 2 x 30 (paged: split and combine) per decode tick
   and 2 x 91 per chunk tick, every tick after a key's build is a replay
   of it, each key's graph holds its tick's launches, no NaN
   appears in the logits or the KV pool, and a pooled decode tick on live
   engine state agrees with the plain versions layer by layer: each of the
   30 layers and the head runs under both on the same input, within 5e-2
   in relative norm; a replay of the decode graph agrees with the same
   tick run eagerly through the kernels within 5e-2 in relative norm
   (whether bit for bit is printed). Prints each key's captures, replays,
   launches per replay and capture time, the graphs' shared pool (its
   segments in the allocator's snapshot), decode tok/s over all decode
   ticks and over the replays alone (a key's first tick, its warm-up and
   capture, is set-up). (The whole
   tick's logits through kernels and plain versions are printed, not
   held: bf16 rounding differences grow through a random-init stack.)
6a. Greedy tokens on the card: ``smollm-135m-butterfly-smoke`` in float32
   compute, weights made once from seed 0 on the CPU, served by one engine
   on the card (the kernels, on graphs) and one on the CPU (the plain
   versions): 4 prompts (5, 23, 11 and 3 tokens) into 2 slots, prefill
   chunks of 16 (the 23-token prompt chunks twice), 16 new tokens each,
   three times: eager admission, incremental admission on 3 usable pages
   of 16 (at least one preemption and recompute required) and ``spec_k=3``
   speculative decoding; and a fourth time on the card through two
   replicas behind a ``Router`` on its driver thread, replica 0 swapping
   in mid-run a port-written checkpoint of the same weights whose newest
   step is torn (the swap must restore the older step), then the prompts
   again (some on the swapped replica). The tokens must be equal; at a
   flip the request, the step and the CPU run's top-1 minus top-2 logit
   gap there are printed and the phase fails; the card's sandwich and
   paged launch counters must rise.
6b. Incremental admission at full width: the 16 requests of phase 6 on a
   pool of 40 usable pages (a fifth of the dense-equivalent 256), on
   graphs: at least one preemption, every request finished, launch
   counters on the per-tick formula; ticks, preemptions, recompute tokens,
   peak pages, TTFT and decode tok/s printed, and how many bfloat16 tokens
   agree with phase 6's eager-admission run (not held: a recomputed prefix
   rounds otherwise than decoding did in bfloat16).
6c. Speculative decoding at full width: ``spec_k`` 3 on a probe engine's
   live state, the draft and verify graphs' replay against the same verify
   pass run eagerly through the kernels, within 5e-2 in relative norm
   (whether bit for bit is printed); then the 16 requests of phase 6 on
   graphs: every request finished, the launch counters on the formula
   (2 x 91 per verify and chunk tick, 2 x 3 head calls per draft, no paged
   launch: the verify reads the pool through the plain gather), each key's
   replays and launches per replay held; acceptance, tok/s and how many
   bfloat16 tokens agree with phase 6's run printed (not held).
6d. The serving tier at full width through the CLI,
   ``launch.serve.main`` in process: ``smollm-135m-butterfly`` in
   bfloat16, 2 replicas x 8 slots, max_len 512, 32 requests of 5-200
   uniform prompt tokens and 32 new tokens, open loop at 10 req/s, four
   times in turns: without a live ``Tracer``, with one (``--trace-out``),
   with one, without. Held: every request finished, no replica dead, each
   Chrome trace valid under ``repro_torch.obs.validate`` with one
   ``finish`` per request, and each run's launch counters (summed over
   both replicas: the counters are process-wide) equal to the per-tick
   formula summed over both engines' ticks. Printed per run: the router
   snapshot's TTFT and latency p50/p95 and dispatch, decode tok/s and the
   mean tick; then both means with and without the tracer, and the
   phase's seconds.
7. Timing: each forward kernel, its plain twin, and one library call as
   a yardstick the port never calls (for the sandwich a ``torch.matmul``
   by its materialized dense matrix, at 8 rows and at the training run's
   8192, each with its bound, by CUDA events; for the paged kernels
   ``scaled_dot_product_attention`` over gathered KV, at both shapes of 4,
   by device time from ``torch.profiler`` beside the CUDA-event figure over
   back-to-back calls, which the host's enqueue can set); each kernel's
   bound from its bytes and operations (the sandwich's on the support it
   needs) over the H100's 3.35 TB/s and peak rates.
8. Profile: ``torch.profiler`` over three pooled decode ticks replayed
   from the decode graph and three of the same ticks run eagerly through
   the kernels — device time by kernel and the device-busy share of the
   ticks' wall time; each sandwich and paged kernel's launches a tick in
   the graphed ticks' device trace must equal the decode graph's launches
   per replay.
9. Training: ``Trainer`` on full-width ``smollm-135m-butterfly`` (bf16
   compute, remat), seq_len 2048 x batch 4, 2 warm and 5 timed steps;
   finite losses, 2 x 181 forward and 6 x 91 backward sandwich launches
   per step; one more step under ``torch.profiler``.
10. Gradient checks of one step (seq_len 256, batch 1): each layer and the
    head under the kernels and the plain versions on the plain path's
    inputs and cotangents, every butterfly leaf within 5e-2 in relative
    norm; and the whole step in float32 compute, every butterfly leaf
    within 1e-3.
11. Timing of the backward kernels per train step, their plain twin, their
    bound, and the dense layer's backward by ``torch.matmul`` (``dx = g·W``,
    ``dW = gᵀ·x`` by the materialized W) as the yardstick, at 256 rows and
    at the training run's 8192.
12. Butterfly kernels (forward and backward) vs their plain twins at the
    encoder's 70,000 x 1024, Olivetti faces' 400 x 4096, 5 x 1024,
    1237 x 2048, 300 x 8192 and 64 x 32,768 (the widest the kernels take),
    both directions, float32 within 1e-5 and
    bfloat16 within 5e-2 of max|want|; the backward with and without dx,
    two launches bit-identical, its stage applications for the first row
    equal to ``stage_applies`` and at most 3p.
13. The encoder-decoder (paper §4) at the MNIST auto-encoder's shape:
    n = 784 (padded to 1024), d = 70,000, k = 32, on the stand-in
    ``synthetic_image_matrix(784, 70000, 0)``: the closed-form loss against
    the Theorem 1 prediction (rtol 1e-3), FJLT+PCA, and the two-phase row
    of ``launch.encdec`` (400 + 300 Adam steps) with finite losses, phase 1
    no better than the prediction, phase 2 within 1.02 of phase 1, and the
    butterfly launches the design implies; step time p50 and peak memory.
14. The same path through kernels and plain versions, float32: one
    gradient of B, E, D within 1e-4 and 10 phase-2 losses at rtol 1e-4.
15. Timing of the butterfly kernels at 70,000 x 1024: kernel, plain twin,
    bound, and for the forward a matmul by the materialized B, by device
    time beside CUDA events; then both kernels by device time at every
    shape of the butterfly checks.
16. Flash-attention kernels (forward, dq, dkv) vs their plain twins: o and
    lse, and dq/dk/dv for one dO, at (a) the training attention of
    ``smollm-135m-butterfly`` (B 4, H 9, S 2048, D 64, bf16, causal), (b)
    ``bench_backward``'s B 1, H 2, D 64, float32, causal at S 1024 and
    8192, (c) a ``gemma3-27b`` local layer (B 1, H 32, S 4096, D 128,
    window 1024, bf16), (d) B 2, H 3, S 1000, D 256, non-causal, float32,
    (e) D 8 and 192 at S 77, ``causal=False, window=24``, both dtypes;
    forward within 1e-5 (float32) / 2e-2 (bf16) of max|want|, lse 1e-5,
    gradients 1e-4 / 5e-2; two backward launches bit-identical.
17. The benches (``launch.speed``): every ``kernel/*``, ``speed/*`` and
    ``backward/*`` row at the reference's sizes, with the counts set to 0
    just before and read just after; every row present and timed, and the
    launches of every kernel equal to what the timed calls imply.
18. ``FlashFn`` through autograd at (a), kernels against plain twins, 1
    forward and 2 backward launches per call.
19. Timing of the flash kernels at (a) and (b): kernel, plain twin,
    bound, ``scaled_dot_product_attention`` forward and backward, and at
    (a) the port's plain ``_attend_masked`` in grouped layout; the three
    kernels and SDPA's forward and backward by device time beside their
    CUDA-event figures, the float32 kernels' bounds at the 3xTF32 rate
    (495/3 TFLOP/s) beside the CUDA-core ones.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Any failed phase raises and the script
exits non-zero without the last line; so does a machine without a CUDA
device or a directory without ``src/repro_torch``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 TC / fp32
# a float32 route on the tensor cores in 3xTF32 (three TF32 products for
# each float32 one): the TF32 peak over three
PEAK_3XTF32 = 495e12 / 3
PROFILE_TRIES = 3         # device_ms: profiler windows read before it raises
SANDWICH_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
FACTOR_TOL = 1e-5         # the factors are float32 in both routes
WIDEST = ("widest", 32, 262144)   # n2 = 4096 x 64, the kernels' limit
# mistral-large-123b's down site (configs/mistral_large_123b.py: d_ff 28,672
# -> d_model 12,288): n1 = 32,768, the sandwich kernels' widest input
WIDE = ("mistral_down", 28672, 12288)
WIDE_ROWS = 64
PAGED_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SLOTS, MAX_LEN, CHUNK, NEW_TOKENS, N_REQUESTS = 8, 512, 16, 32, 16
SPEC_K = 3                # draft tokens per slot tick of the speculative run
# incremental admission's pool: 40 usable pages of 16 (plus the trash page),
# a fifth of the dense-equivalent 8 x 512 / 16 = 256
INCR_PAGES = 41
LAYER_TOL = 5e-2          # bf16 model checks, relative norm per layer
# the paged kernel's shapes (cur_pos per slot, pages of 16): the serving
# engine's (max_len 512) and a long one at the 2048-token context of
# SmolLM-135M, the training run's seq_len (7,883 live positions)
PAGED_SHAPES = (("serve", (0, 15, 16, 100, 255, 300, 511, 47), MAX_LEN),
                ("long", (2047, 2000, 1500, 1024, 777, 511, 16, 0), 2048))


def say(*parts) -> None:
    sys.stdout.write(" ".join(str(p) for p in parts) + "\n")
    sys.stdout.flush()


def sites(cfg) -> dict:
    """The sandwich sites of ``cfg``: name -> (site key, n_in, n_out)."""
    E, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    return {"up_gate": ("mlp_up", E, F), "down": ("mlp_down", F, E),
            "lm_head": ("lm_head", E, V)}


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_ms(torch, fn, reps: int, warm: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls, timed
    with CUDA events after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int, warm: int = 3) -> float:
    """Device milliseconds per call of ``fn``: the durations of the kernels
    and copies it launches, read from ``torch.profiler`` over ``reps``
    calls after ``warm`` calls. Unlike :func:`cuda_ms`, the host's enqueue
    rate cannot set it: gaps between launches do not count. The profiler
    records a window of ``reps`` calls after a window of as many that it
    traces and drops: without it the profiler lost some of the first
    calls' kernels, and at a window's edge it may still drop one or carry
    one over. So each kernel's mean duration counts as many times a call
    as it ran per call, rounded (a kernel seen fewer than reps/2 times is
    a stray and does not count); a window with no device time is read
    again, up to PROFILE_TRIES times, and then raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        us = sum(e.self_device_time_total / e.count * round(e.count / reps)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.count)
        if us:
            return us / 1e3
        say(f"device_ms: no device time over {reps} calls; read again")
    raise RuntimeError(f"device_ms: the profiler saw no device time over "
                       f"{reps} calls in each of {PROFILE_TRIES} windows")


def clocks(dev) -> str:
    """The card's SM clock and power draw now, for a timing line (calls
    land on cards at other clocks); empty off the card."""
    if dev.type != "cuda":
        return ""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return f"; SM clock, power after: {out}"


def allclose_or_raise(torch, what, got, want, tol) -> float:
    """Max |got - want|; raises unless |got - want| <= tol + tol·|want|
    everywhere and ``got`` is finite."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (got - want).abs()
    limit = tol + tol * want.abs()
    if not bool((err <= limit).all()):
        rel = float((got - want).norm() / want.norm())
        raise AssertionError(f"{what}: max |err| {float(err.max()):.3e} "
                             f"beyond atol=rtol={tol} (relative norm "
                             f"{rel:.3e}, {int((err > limit).sum())} of "
                             f"{err.numel()} outside)")
    return float(err.max())


# -- phases -----------------------------------------------------------------

def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    # the plain float32 twins and the encoder-decoder's products must stay
    # float32: no TF32 in matmuls or convolutions (set and checked)
    from repro_torch.launch.encdec import full_float32
    full_float32()
    say("device:", torch.cuda.get_device_name(0), "| count:",
        torch.cuda.device_count(), "| torch", torch.__version__, "cuda",
        torch.version.cuda)
    say(smi)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.monotonic()
    logs = build.build()
    say(f"build: {time.monotonic() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("Function properties", "registers",
                                       "spill", "smem")):
                say(f"ptxas[{name}]: {line.strip()}")
    for name in ("butterfly", "butterfly_bwd"):
        say(f"ptxas[{name}] spills: {ptxas_spills(logs[name])}")


def ptxas_spills(log: str) -> str:
    """The kernels of one ``-Xptxas -v`` report with their spill stores:
    how many kernels, the most registers one uses, and each that spills."""
    import re
    kernels, spills, regs = 0, [], 0
    name = "?"
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, kernels = m.group(1), kernels + 1
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and int(m.group(1)):
            spills.append(f"{name} {m.group(1)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = max(regs, int(m.group(1)))
    return (f"{kernels} kernels, at most {regs} registers, "
            + (f"spill stores in {len(spills)}: " + "; ".join(spills)
               if spills else "no spill stores"))


def sandwich_site(torch, cfg, site: str, dev):
    """Spec and random weights of one full-width sandwich site."""
    from repro_torch.models import common as cm
    from repro_torch.nn import ButterflyLinear
    key, n_in, n_out = sites(cfg)[site]
    bc = cfg.butterfly
    spec = cm.site_butterfly_spec(bc.seed, key, n_in, n_out, bc.k_factor,
                                  bc.use_bias)
    layer = ButterflyLinear(spec, generator=torch.Generator().manual_seed(7))
    return spec, layer.to(dev)


def sandwich_call(torch, spec, layer, x, backend):
    from repro_torch.kernels import sandwich as ks
    return ks.sandwich_forward(
        x, layer.b_in, layer.core, layer.b_out, layer.idx_in, layer.idx_out,
        scale_in=spec.scale_in, scale_out=spec.scale_out, n_out=spec.n_out,
        backend=backend)


def phase_sandwich_factors(torch, cfg, dev, kernel: str) -> float:
    """The factor kernel against its plain twin at the three full-width
    sites and the widest output, for both dtypes the weights are rounded
    to: F_in and F_out within FACTOR_TOL (atol = rtol)."""
    from repro_torch.core import layers as blayers
    from repro_torch.kernels import sandwich as ks
    from repro_torch.nn import ButterflyLinear
    worst = 0.0
    cases = [(site, *sandwich_site(torch, cfg, site, dev)) for site in
             sites(cfg)]
    name, n_in, n_out = WIDEST
    gen = torch.Generator().manual_seed(11)
    spec = blayers.make_spec(gen, n_in, n_out, use_bias=False)
    cases.append((name, spec, ButterflyLinear(spec, generator=gen).to(dev)))
    for site, spec, layer in cases:
        for dtype in ("float32", "bfloat16"):
            got, want = (ks.sandwich_factors(
                layer.b_in.detach(), layer.b_out.detach(), layer.idx_in,
                layer.idx_out, n_in=spec.n_in, n_out=spec.n_out,
                dtype=getattr(torch, dtype), backend=b)
                for b in (kernel, "torch"))
            sync(torch, dev)
            errs = [allclose_or_raise(
                torch, f"sandwich factors {site} {dtype} {part}", g, w,
                FACTOR_TOL) for part, g, w in zip(("F_in", "F_out"), got,
                                                   want)]
            say(f"sandwich factors {site:8s} {dtype:9s} F_in "
                f"{tuple(got[0].shape)} F_out {tuple(got[1].shape)}: "
                f"max|err| {errs[0]:.3e} / {errs[1]:.3e} (tol {FACTOR_TOL})")
            worst = max(worst, *errs)
    return worst


def phase_sandwich(torch, cfg, dev, kernel: str, train_rows: int) -> float:
    """The forward kernel against its plain twin at the three full-width
    sites: the decode, verify and chunk ticks' rows and the training
    run's."""
    worst = 0.0
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for site in sites(cfg):
            spec, layer = sandwich_site(torch, cfg, site, dev)
            for rows in sorted({SLOTS, SLOTS * (SPEC_K + 1), SLOTS * CHUNK,
                                train_rows}):
                for dtype in ("float32", "bfloat16"):
                    x = torch.randn(rows, spec.n_in, generator=gen).to(
                        dev, getattr(torch, dtype))
                    got = sandwich_call(torch, spec, layer, x, kernel)
                    want = sandwich_call(torch, spec, layer, x, "torch")
                    sync(torch, dev)
                    err = allclose_or_raise(
                        torch, f"sandwich {site} rows={rows} {dtype}", got,
                        want, SANDWICH_TOL[dtype])
                    say(f"sandwich {site:8s} rows={rows:4d} {dtype:9s} "
                        f"max|err|={err:.3e} (tol {SANDWICH_TOL[dtype]})")
                    if dtype == cfg.compute_dtype:
                        worst = max(worst, err)
    return worst


def paged_inputs(torch, cfg, dtype, dev, seed=2, shape=PAGED_SHAPES[0]):
    """q, pools, page table and cur_pos at one of PAGED_SHAPES (the
    engine's decode shape by default), with a dirty trash page, stale rows
    and NaN pages past cur_pos."""
    from repro_torch.kernels import paged_attention as pa
    KV, D = cfg.n_kv_heads, cfg.head_dim_
    G = cfg.n_heads // KV
    _, cur, max_len = shape
    ps, P = 16, max_len // 16
    gen = torch.Generator().manual_seed(seed)
    N = 1 + SLOTS * P
    k_pool = torch.randn(N, ps, KV, D, generator=gen)
    v_pool = torch.randn(N, ps, KV, D, generator=gen)
    ids = (torch.randperm(N - 1, generator=gen) + 1).reshape(SLOTS, P)
    cur = torch.tensor(cur)
    k_pool[pa.TRASH_PAGE] = 1e4
    v_pool[pa.TRASH_PAGE] = -1e4
    for b in range(SLOTS):
        last, off = int(cur[b]) // ps, int(cur[b]) % ps + 1
        k_pool[ids[b, last], off:] = 7e3
        v_pool[ids[b, last], off:] = -7e3
        for p in range(last + 1, P):
            k_pool[ids[b, p]] = float("nan")
            v_pool[ids[b, p]] = float("nan")
    q = torch.randn(SLOTS, KV, G, D, generator=gen)
    return [q.to(dev, dtype), k_pool.to(dev, dtype), v_pool.to(dev, dtype),
            ids.int().to(dev), cur.int().to(dev)]


def phase_paged(torch, cfg, dev, kernel: str) -> float:
    """The paged kernels against their plain twin at PAGED_SHAPES, both
    dtypes; two launches bit-identical."""
    from repro_torch.kernels import paged_attention as pa
    worst = 0.0
    with torch.no_grad():
        for shape in PAGED_SHAPES:
            for dtype in ("float32", "bfloat16"):
                args = paged_inputs(torch, cfg, getattr(torch, dtype), dev,
                                    shape=shape)
                got = pa.paged_decode_attention(*args, backend=kernel)
                again = pa.paged_decode_attention(*args, backend=kernel)
                want = pa.paged_decode_attention(*args, backend="torch")
                sync(torch, dev)
                if not torch.equal(got, again):
                    raise AssertionError(f"paged {shape[0]} {dtype}: two "
                                         f"launches differ")
                err = allclose_or_raise(torch, f"paged {shape[0]} {dtype}",
                                        got, want, PAGED_TOL[dtype])
                say(f"paged {shape[0]:5s} B={SLOTS} {tuple(args[0].shape)} "
                    f"ps=16 P={args[3].shape[1]} {dtype:9s} max|err|="
                    f"{err:.3e} (tol {PAGED_TOL[dtype]}); two launches "
                    f"bit-identical")
                if dtype == cfg.compute_dtype and shape is PAGED_SHAPES[0]:
                    worst = max(worst, err)
    return worst


_MODELS = {}


def model_of(cfg, dev):
    """The served model: random weights from seed 0, built once per run."""
    from repro_torch.serve import loader
    if (cfg, dev) not in _MODELS:
        _MODELS.clear()
        _MODELS[cfg, dev] = loader.init_params(cfg, seed=0, device=dev)
    return _MODELS[cfg, dev]


def layerwise_check(torch, eng, kernel: str) -> None:
    """The pooled decode tick ``eng`` would run next, one layer at a time
    on a copy of its KV pool: each layer, then the final norm and head, runs
    under ``kernel`` and under the plain versions on the same input, the
    plain path's state, so each comparison sees one layer's rounding and
    not its growth through the stack after it. Each output must be finite
    and within 5e-2 of the plain one in relative norm, |got - want| /
    |want|. The norm, not a per-element bound: the residual add can cancel
    large terms, so one bfloat16 step of a term (8 at magnitude 1024) may
    land on a small output element."""
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.serve import steps
    cfg, model, tol = eng.cfg, eng.model, LAYER_TOL
    tokens, cur_pos, active = (torch.from_numpy(a).to(eng.device)
                               for a in eng.decode_inputs())
    table = steps.mask_table(eng.pool.gather_args()["page_table"], active)
    caches = {t: c.clone() for t, c in eng.caches.items()}
    positions = cur_pos[:, None].contiguous()
    pairs = []
    with torch.no_grad():
        x = cm.embed(cfg, model.embed, tokens[:, None])
        for i, layer in enumerate(model.layers):
            cache = (caches["k"][i], caches["v"][i])
            got, want = (lm.layer_apply(cfg, layer, x, positions=positions,
                                        cache=cache, page_table=table,
                                        backend=b) for b in (kernel, "torch"))
            pairs.append((f"layer {i}", got.float(), want.float()))
            x = want
        h = cm.rmsnorm(x, model.final_norm, cfg.norm_eps)
        got, want = (cm.head_apply(cfg, model.head, h, b)[:, 0]
                     for b in (kernel, "torch"))
        pairs.append(("logits", got.float(), want.float()))
    rel = [float((g - w).norm() / w.norm()) for _, g, w in pairs]
    big = [float((g - w).abs().max()) for _, g, w in pairs]
    say(f"decode tick layer by layer, kernels vs plain on the same input, "
        f"relative norm of the difference per layer: "
        f"{' '.join(f'{e:.1e}' for e in rel[:-1])}; logits {rel[-1]:.3e}; "
        f"tol {tol}; max|err| {max(big):.3e} ({pairs[big.index(max(big))][0]})"
        f", logits {big[-1]:.3e} at |logit| max "
        f"{float(pairs[-1][2].abs().max()):.2f}")
    for (what, got, _), r in zip(pairs, rel):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"decode tick {what}: not finite")
        if not r <= tol:
            raise AssertionError(f"decode tick {what}: relative norm of the "
                                 f"difference {r:.3e} beyond {tol}")


def replay_vs_eager(torch, eng, kernel: str) -> dict:
    """The next pooled decode tick's logits through a replay of the engine's
    decode graph (``replay_decode_logits``) against the same tick run
    eagerly through the kernels (``decode_logits``), on the same state:
    finite and within ``LAYER_TOL`` in relative norm; reports whether they
    are bit for bit."""
    eager = eng.decode_logits(backend=kernel)
    graph = eng.replay_decode_logits()
    if not bool(torch.isfinite(graph).all()):
        raise AssertionError("replayed decode logits are not finite")
    g, e = graph.float(), eager.float()
    out = {"rel": float((g - e).norm() / e.norm()),
           "max_abs": float((g - e).abs().max()),
           "bitwise": bool(torch.equal(graph, eager))}
    say(f"decode tick replay vs eager ({kernel}), {eng.cfg.compute_dtype}: "
        f"relative norm of the difference {out['rel']:.3e} (tol "
        f"{LAYER_TOL}), max|err| {out['max_abs']:.3e}, bit for bit: "
        f"{out['bitwise']}")
    if not out["rel"] <= LAYER_TOL:
        raise AssertionError(f"replayed decode logits differ from the eager "
                             f"tick by {out['rel']:.3e} in relative norm")
    return out


def serve_launches_want(cfg, snap, on_card: bool, spec_k: int = 0) -> dict:
    """Kernel launches a serving run must count: the sandwich's
    ``FWD_KERNELS`` at every site (up, gate, down per layer and the head)
    per decode (or verify) and chunk tick, and at the head ``spec_k`` times
    per speculative tick's draft; the paged kernels' ``PAGED_KERNELS`` per
    layer per decode tick (a verify pass reads the pool through the plain
    gather, as the chunk does); none off the card."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    per_tick = 3 * cfg.n_layers + 1
    decode = snap["decode_steps"]
    return {"sandwich_fwd": on_card * ks.FWD_KERNELS
            * (per_tick * (decode + snap["chunk_ticks"]) + spec_k * decode),
            "paged_decode_attention": on_card * pa.PAGED_KERNELS
            * cfg.n_layers * decode * (not spec_k)}


def read_launches() -> dict:
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    return {"sandwich_fwd": ks.sandwich_forward.launches,
            "paged_decode_attention": pa.paged_decode_attention.launches}


def zero_launches() -> None:
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    ks.sandwich_forward.launches = 0
    pa.paged_decode_attention.launches = 0


def graph_report(eng, snap, on_card: bool) -> dict:
    """Print each graph key's captures, replays, kernel launches per replay
    and warm-up and capture seconds, and the graphs' shared pool; hold the
    replays to the ticks (every tick after a key's build is a replay) and,
    on the card, each key's launches per replay to the per-tick formula."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    cfg, stats = eng.cfg, eng.graphs.stats()
    ticks = {"decode": snap["decode_steps"], "chunk_prefill":
             snap["chunk_ticks"], "spec_draft": snap["decode_steps"],
             "spec_verify": snap["decode_steps"]}
    # (sandwich, paged) launches of one replay: every site of the model, or
    # the head alone spec_k times in the draft; the paged kernels in the
    # decode tick only
    sites_ = ks.FWD_KERNELS * (3 * cfg.n_layers + 1)
    per_replay = {"decode": (sites_, pa.PAGED_KERNELS * cfg.n_layers),
                  "chunk_prefill": (sites_, 0), "spec_verify": (sites_, 0),
                  "spec_draft": (ks.FWD_KERNELS * eng.spec_k, 0)}
    for key, st in stats.items():
        say(f"graph {key}: captures {st['captures']}, replays "
            f"{st['replays']}, launches per replay "
            f"{st['launches_per_replay']}, warm-up {st['warmup_s']:.3f} s, "
            f"capture {st['capture_s']:.3f} s")
        kind = key.split(" | ")[0]
        if st["replays"] != ticks[kind] - 1:
            raise AssertionError(f"graph {key}: {st['replays']} replays for "
                                 f"{ticks[kind]} ticks")
        want = dict(zip(("sandwich_fwd", "paged_decode_attention"),
                        per_replay[kind]))
        if on_card and st["launches_per_replay"] != want:
            raise AssertionError(f"graph {key}: launches per replay "
                                 f"{st['launches_per_replay']}, expected "
                                 f"{want}")
    pool = eng.graphs.pool_bytes()
    capture = sum(st["capture_s"] for st in stats.values())
    say(f"graphs: {len(stats)} keys, capture {capture:.3f} s in all, shared "
        f"graph pool " + ("not measured (the allocator's snapshot names no "
                          "pools)" if pool is None else
                          f"{pool / 2**20:.1f} MiB (its segments in the "
                          f"allocator's snapshot)"))
    return {"pool_bytes": pool, **{
        key: {n: st[n] for n in ("replays", "launches_per_replay",
                                 "capture_s")} for key, st in stats.items()}}


def serve_prompts(np, cfg):
    rng = np.random.default_rng(0)
    lens = rng.permutation(np.linspace(5, 200, N_REQUESTS).astype(int))
    return lens, [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]


def phase_serve(torch, np, cfg, dev, kernel: str) -> tuple:
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    from repro_torch.serve import Request, ServeEngine

    t0 = time.monotonic()
    model = model_of(cfg, dev)
    say(f"init: {time.monotonic() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    lens, prompts = serve_prompts(np, cfg)
    per_tick = 3 * cfg.n_layers + 1            # up, gate, down per layer + head

    # kernels vs plain on live engine state (also warms the path up)
    probe = ServeEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN,
                        prefill_chunk=CHUNK, device=dev)
    for n in range(SLOTS):                     # <= 12 tokens: one chunk each
        probe.submit(Request(prompt=prompts[n][:5 + n],
                             max_new_tokens=NEW_TOKENS))
    probe.step()
    layerwise_check(torch, probe, kernel)
    # the whole tick through both paths, for the record only: rounding
    # differences of bf16 compound over the random-init layer stack
    auto = probe.decode_logits(backend=kernel)
    plain = probe.decode_logits(backend="torch")
    sync(torch, dev)
    say(f"decode-tick logits through all {cfg.n_layers} layers, kernels vs "
        f"plain (not held): max|err|="
        f"{float((auto.float() - plain.float()).abs().max()):.3e}, "
        f"argmax agrees on {int((auto.argmax(-1) == plain.argmax(-1)).sum())}"
        f" of {SLOTS} slots")
    replay = replay_vs_eager(torch, probe, kernel)
    del probe

    # the main path: counters from 0, 16 requests to completion
    eng = ServeEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN,
                      prefill_chunk=CHUNK, device=dev)
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    futs = [eng.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS))
            for p in prompts]
    t0 = time.monotonic()
    eng.run_until_idle()
    sync(torch, dev)
    wall = time.monotonic() - t0
    launches = read_launches()
    snap = eng.metrics.snapshot()
    tokens = [f.result(timeout=0).tokens for f in futs]
    for i, toks in enumerate(tokens):
        if len(toks) != NEW_TOKENS:
            raise AssertionError(f"request {i}: {len(toks)} tokens, "
                                 f"expected {NEW_TOKENS}")
    on_card = dev.type == "cuda"       # on the CPU the plain versions run
    want = serve_launches_want(cfg, snap, on_card)
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    for name, pool in eng.caches.items():
        if not bool(torch.isfinite(pool).all()):
            raise AssertionError(f"non-finite values in the {name} pool")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    say(f"serve: {N_REQUESTS} requests, prompts {int(lens.min())}-"
        f"{int(lens.max())} tokens, {snap['ticks']} ticks "
        f"({snap['chunk_ticks']} chunk, {snap['decode_steps']} decode), "
        f"wall {wall:.3f} s, on graphs ({eng.compile_stats['compiles']} "
        f"built)")
    say(f"serve: TTFT p50 {snap['ttft_ms']['p50']} ms, p95 "
        f"{snap['ttft_ms']['p95']} ms; TPOT p50 {snap['tpot_ms']['p50']} ms; "
        f"decode {snap['decode_tok_per_s']:.1f} tok/s over all decode ticks, "
        f"{snap['decode_tok_per_s_steady']:.1f} tok/s over the replays; "
        f"{snap['build']['ticks']} ticks built a graph, "
        f"{snap['build']['time_s']:.3f} s in all (set-up); peak memory "
        f"{peak / 2**20:.1f} MiB")
    m = eng.metrics
    replayed = (m.decode_time_s - m.build_decode_time_s) * 1e3 / (
        m.decode_steps - 1)
    say(f"serve: decode ticks, host clock: {replayed:.3f} ms a replayed "
        f"tick on average over {m.decode_steps - 1}; the "
        f"decode key's build tick (warm-up + capture) "
        f"{m.build_decode_time_s * 1e3:.3f} ms")
    say(f"serve: launches {launches} = {ks.FWD_KERNELS} x {per_tick}/tick x "
        f"(decode + chunk), {pa.PAGED_KERNELS} x {cfg.n_layers}/decode tick")
    graphs = graph_report(eng, snap, on_card)
    summary = {"ttft_p50_ms": snap["ttft_ms"]["p50"],
               "ttft_p95_ms": snap["ttft_ms"]["p95"],
               "tpot_p50_ms": snap["tpot_ms"]["p50"],
               "decode_tok_per_s": snap["decode_tok_per_s"],
               "decode_tok_per_s_steady": snap["decode_tok_per_s_steady"],
               "build_s": snap["build"]["time_s"],
               "replayed_decode_tick_ms": replayed,
               "peak_mib": peak / 2**20, "wall_s": wall,
               "ticks": snap["ticks"], "graphs": graphs,
               "replay_vs_eager": replay}
    return launches, summary, tokens


def phase_serve_incremental(torch, np, cfg, dev, eager_tokens) -> dict:
    """The main path's 16 requests under incremental admission on a pool of
    ``INCR_PAGES - 1`` usable pages, a fifth of the dense-equivalent 256:
    at least one preemption, every request finished with its tokens, the
    launch counters on the per-tick formula. Prints how many tokens agree
    with the eager-admission run (not held: in bfloat16 a recomputed prefix
    rounds otherwise than decoding did)."""
    from repro_torch.serve import Request, ServeEngine
    _, prompts = serve_prompts(np, cfg)
    eng = ServeEngine(cfg, model_of(cfg, dev), slots=SLOTS, max_len=MAX_LEN,
                      prefill_chunk=CHUNK, num_pages=INCR_PAGES,
                      admission="incremental", device=dev)
    sync(torch, dev)
    zero_launches()
    futs = [eng.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS))
            for p in prompts]
    t0 = time.monotonic()
    eng.run_until_idle()
    sync(torch, dev)
    wall = time.monotonic() - t0
    launches = read_launches()
    snap = eng.metrics.snapshot()
    tokens = [f.result(timeout=0).tokens for f in futs]
    if any(len(t) != NEW_TOKENS for t in tokens):
        raise AssertionError("incremental run: a request came back short")
    if snap["preempted"] < 1:
        raise AssertionError(f"incremental run on {INCR_PAGES - 1} pages "
                             f"preempted nothing")
    want = serve_launches_want(cfg, snap, dev.type == "cuda")
    if launches != want:
        raise AssertionError(f"incremental run: launch counts {launches}, "
                             f"expected {want}")
    same = sum(a == b for x, y in zip(tokens, eager_tokens)
               for a, b in zip(x, y))
    whole = sum(x == y for x, y in zip(tokens, eager_tokens))
    total = sum(map(len, tokens))
    say(f"serve incremental: {INCR_PAGES - 1} usable pages, {snap['ticks']} "
        f"ticks ({snap['chunk_ticks']} chunk, {snap['decode_steps']} "
        f"decode), {snap['preempted']} preemptions, "
        f"{snap['recompute_tokens']} recompute tokens, peak pages "
        f"{snap['pool']['pages_hwm']}, max concurrent slots "
        f"{snap['max_concurrent_slots']}, wall {wall:.3f} s")
    say(f"serve incremental: TTFT p50 {snap['ttft_ms']['p50']} ms, p95 "
        f"{snap['ttft_ms']['p95']} ms; TPOT p50 {snap['tpot_ms']['p50']} ms; "
        f"decode {snap['decode_tok_per_s']:.1f} tok/s over all decode ticks, "
        f"{snap['decode_tok_per_s_steady']:.1f} over the replays; launches "
        f"{launches}")
    say(f"serve incremental: {cfg.compute_dtype} tokens equal to the eager "
        f"admission run at {same} of {total} positions, {whole} of "
        f"{len(tokens)} requests whole (not held)")
    return {"incr_ticks": snap["ticks"], "incr_preempted": snap["preempted"],
            "incr_recompute_tokens": snap["recompute_tokens"],
            "incr_pages_hwm": snap["pool"]["pages_hwm"],
            "incr_decode_tok_per_s": snap["decode_tok_per_s"],
            "incr_decode_tok_per_s_steady": snap["decode_tok_per_s_steady"],
            "incr_ttft_p50_ms": snap["ttft_ms"]["p50"],
            "incr_ttft_p95_ms": snap["ttft_ms"]["p95"],
            "incr_tokens_agree": same, "incr_tokens": total}


def verify_replay_vs_eager(torch, eng, kernel: str) -> dict:
    """The next speculative tick's verify logits through replays of the
    engine's draft and verify graphs (``replay_verify_logits``) against the
    verify pass run eagerly through the kernels on the same drafts
    (``verify_logits``), on the same state: finite and within ``LAYER_TOL``
    in relative norm; reports whether they are bit for bit."""
    tokens, graph = eng.replay_verify_logits()
    eager = eng.verify_logits(tokens, backend=kernel)
    if not bool(torch.isfinite(graph).all()):
        raise AssertionError("replayed verify logits are not finite")
    g, e = graph.float(), eager.float()
    out = {"rel": float((g - e).norm() / e.norm()),
           "max_abs": float((g - e).abs().max()),
           "bitwise": bool(torch.equal(graph, eager))}
    say(f"verify tick replay vs eager ({kernel}), {eng.cfg.compute_dtype}, "
        f"{tuple(tokens.shape)} tokens: relative norm of the difference "
        f"{out['rel']:.3e} (tol {LAYER_TOL}), max|err| "
        f"{out['max_abs']:.3e}, bit for bit: {out['bitwise']}")
    if not out["rel"] <= LAYER_TOL:
        raise AssertionError(f"replayed verify logits differ from the eager "
                             f"pass by {out['rel']:.3e} in relative norm")
    return out


def phase_serve_spec(torch, np, cfg, dev, kernel: str, eager_tokens) -> dict:
    """The main path's 16 requests with ``spec_k = SPEC_K`` at full width,
    on graphs (the draft through the butterfly head, the verify in one
    batched pass). First, on a probe engine's live state, a replay of the
    draft and verify graphs against the same verify pass run eagerly
    (:func:`verify_replay_vs_eager`). Then every request finished with its
    tokens, the launch counters on the formula and every graph key's
    replays and launches per replay held; acceptance, tok/s and how many
    bfloat16 tokens agree with the eager-admission run printed (not held:
    the verify pass's products have other shapes than a decode tick's, so
    they round otherwise)."""
    from repro_torch.serve import Request, ServeEngine
    model = model_of(cfg, dev)
    _, prompts = serve_prompts(np, cfg)
    probe = ServeEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN,
                        prefill_chunk=CHUNK, spec_k=SPEC_K, device=dev)
    for n in range(SLOTS):
        probe.submit(Request(prompt=prompts[n][:5 + n],
                             max_new_tokens=NEW_TOKENS))
    probe.step()                     # the chunk, then the first spec tick
    replay = verify_replay_vs_eager(torch, probe, kernel)
    del probe
    eng = ServeEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN,
                      prefill_chunk=CHUNK, spec_k=SPEC_K, device=dev)
    sync(torch, dev)
    zero_launches()
    futs = [eng.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS))
            for p in prompts]
    t0 = time.monotonic()
    eng.run_until_idle()
    sync(torch, dev)
    wall = time.monotonic() - t0
    launches = read_launches()
    snap = eng.metrics.snapshot()
    tokens = [f.result(timeout=0).tokens for f in futs]
    if any(len(t) != NEW_TOKENS for t in tokens):
        raise AssertionError("speculative run: a request came back short")
    want = serve_launches_want(cfg, snap, dev.type == "cuda", SPEC_K)
    if launches != want:
        raise AssertionError(f"speculative run: launch counts {launches}, "
                             f"expected {want}")
    graph_report(eng, snap, dev.type == "cuda")
    same = sum(a == b for x, y in zip(tokens, eager_tokens)
               for a, b in zip(x, y))
    whole = sum(x == y for x, y in zip(tokens, eager_tokens))
    total = sum(map(len, tokens))
    sp = snap["spec"]
    say(f"serve spec_k={SPEC_K}: {snap['ticks']} ticks ({snap['chunk_ticks']}"
        f" chunk, {snap['decode_steps']} speculative), acceptance "
        f"{sp['acceptance_rate']} ({sp['accepted_draft_tokens']} of "
        f"{sp['draft_tokens']} drafts), {sp['tokens_per_slot_tick']} tokens "
        f"per slot tick, wall {wall:.3f} s")
    say(f"serve spec_k={SPEC_K}: TTFT p50 {snap['ttft_ms']['p50']} ms, p95 "
        f"{snap['ttft_ms']['p95']} ms; TPOT p50 {snap['tpot_ms']['p50']} ms; "
        f"decode {snap['decode_tok_per_s']:.1f} tok/s over all speculative "
        f"ticks, {snap['decode_tok_per_s_steady']:.1f} over the replays; "
        f"launches {launches}")
    say(f"serve spec_k={SPEC_K}: {cfg.compute_dtype} tokens equal to the "
        f"eager admission run at {same} of {total} positions, {whole} of "
        f"{len(tokens)} requests whole (not held)")
    return {"spec_ticks": snap["ticks"],
            "spec_acceptance": sp["acceptance_rate"],
            "spec_tokens_per_slot_tick": sp["tokens_per_slot_tick"],
            "spec_decode_tok_per_s": snap["decode_tok_per_s"],
            "spec_decode_tok_per_s_steady": snap["decode_tok_per_s_steady"],
            "spec_ttft_p50_ms": snap["ttft_ms"]["p50"],
            "spec_tokens_agree": same, "spec_tokens": total,
            "spec_replay_vs_eager": replay}


TOKEN_PROMPTS = (5, 23, 11, 3)   # tests/test_torch_serve.py's greedy prompts
TOKEN_NEW = 16
# the token runs' engines: eager admission; incremental admission on 3
# usable pages of 16 tokens (two requests' whole budgets do not fit, so
# decoding slots are preempted and recomputed: twice on the CPU); eager
# with 3 drafts a tick
TOKEN_CASES = {"eager": {},
               "incremental": dict(admission="incremental", num_pages=4),
               "spec": dict(spec_k=3),
               "router": {}}
# the router case's driver watchdog: above a first-use nvcc build
TICK_TIMEOUT = 120.0


def serve_router_tokens(cfg, dev, model, prompts) -> tuple:
    """The router token case on ``dev``: two replicas (each its own copy of
    ``model``'s weights) behind a ``Router`` on its driver thread. The
    prompts are submitted; replica 0 then swaps in a checkpoint written
    by the port's ``CheckpointManager`` in the trainer's layout from the
    same weights, steps 1 and 2 with step 2 torn, so the swap must restore
    step 1; then the prompts again, some dispatched to the swapped
    replica. Returns ``(first round's tokens, second round's tokens, the
    router's snapshot)``; raises unless the swap restored step 1, no
    replica died and the swapped replica served in the second round."""
    import copy
    import tempfile

    from repro_torch import convert
    from repro_torch.checkpoint.checkpointing import CheckpointManager
    from repro_torch.serve import Request, Router, ServeEngine
    from repro_torch.serve import tear_checkpoint
    engines = [ServeEngine(cfg, copy.deepcopy(model), slots=2, max_len=48,
                           prefill_chunk=16, device=dev, replica=i)
               for i in range(2)]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        mgr = CheckpointManager(ckpt)
        tree = {"params": convert.to_jax_params(
            dict(model.named_parameters()))}
        mgr.save(1, tree)
        mgr.save(2, tree)
        tear_checkpoint(ckpt)
        with Router(engines, tick_timeout=TICK_TIMEOUT) as router:
            first = [router.submit(Request(prompt=p,
                                           max_new_tokens=TOKEN_NEW))
                     for p in prompts]
            step = router.swap_checkpoint(0, ckpt, timeout=600)
            before = router.replicas[0].dispatched
            second = [router.submit(Request(prompt=p,
                                            max_new_tokens=TOKEN_NEW))
                      for p in prompts]
            rounds = [[f.result(timeout=600).tokens for f in futs]
                      for futs in (first, second)]
        snap = router.snapshot()
    dead = [p["dead"] for p in snap["per_replica"] if p["dead"]]
    if step != 1 or snap["swaps"] != 1 or dead:
        raise AssertionError(f"router token case: swap restored step "
                             f"{step}, {snap['swaps']} swaps, dead {dead}")
    if router.replicas[0].dispatched == before:
        raise AssertionError("router token case: the swapped replica served "
                             "nothing after the swap")
    return rounds[0], rounds[1], snap


def serve_tokens_case(torch, np, dev, mode: str) -> dict:
    """Greedy tokens through the kernels against the plain path, one
    engine configuration of ``TOKEN_CASES``: ``smollm-135m-butterfly-smoke``
    in float32 compute, weights made once from seed 0 on the CPU, one
    engine on ``dev`` (in the router case two replicas behind a
    ``Router``, :func:`serve_router_tokens`) and one on the CPU, the greedy
    test's prompts into 2 slots with prefill chunks of 16. Every request's
    tokens must be equal
    (and the incremental case must preempt); at a flip, prints the request,
    the step and the CPU run's top-1 minus top-2 logit gap there, and
    raises. Returns the card engine's snapshot."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.serve import Request, ServeEngine, loader
    cfg = registry.get("smollm-135m-butterfly-smoke").with_(
        compute_dtype="float32")
    cpu_model = loader.init_params(cfg, seed=0, device="cpu")
    card_model = copy.deepcopy(cpu_model)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in TOKEN_PROMPTS]
    assert max(TOKEN_PROMPTS) > 16             # one prompt chunks twice
    before = read_launches()
    runs, snaps = [], []                    # the card's run, then the CPU's
    for where, model in ((dev, card_model), (torch.device("cpu"),
                                             cpu_model)):
        if mode == "router" and not runs:
            first, second, rsnap = serve_router_tokens(cfg, dev, model,
                                                       prompts)
            runs.append(first + second)
            snaps.append(rsnap["per_replica"][0]["engine"])
            continue
        eng = ServeEngine(cfg, model, slots=2, max_len=48, prefill_chunk=16,
                          device=where, **TOKEN_CASES[mode])
        futs = [eng.submit(Request(prompt=p, max_new_tokens=TOKEN_NEW))
                for p in prompts]
        eng.run_until_idle(max_ticks=1000)
        runs.append([f.result(timeout=0).tokens for f in futs])
        snaps.append(eng.metrics.snapshot())
    card, cpu = runs
    if mode == "router":                    # both rounds against the CPU's
        cpu, prompts = cpu * 2, prompts * 2
    after = read_launches()
    rose = {k: after[k] - before[k] for k in after}
    # every kernel of the path must have launched on the card; a speculative
    # run has no paged decode tick (verify reads the pool through the plain
    # gather, as the chunk does)
    need = ("sandwich_fwd",) + (("paged_decode_attention",)
                                if mode != "spec" else ())
    if dev.type == "cuda" and not all(rose[k] for k in need):
        raise AssertionError(f"the card's engine ({mode}) launched "
                             f"{rose}: none of {need} may be 0")
    snap = snaps[0]
    if mode == "incremental" and not snap["preempted"]:
        raise AssertionError("the incremental token run preempted nothing")
    for i, (a, b) in enumerate(zip(card, cpu)):
        if a == b:
            continue
        step = next(j for j, (u, v) in enumerate(zip(a, b)) if u != v)
        ctx = torch.tensor(np.concatenate([prompts[i], b[:step]]))[None]
        with torch.no_grad():
            x = cm.embed(cfg, cpu_model.embed, ctx)
            pos = torch.arange(ctx.shape[1], dtype=torch.int32)[None]
            x = lm.backbone(cpu_model, x, positions=pos, backend="torch")
            x = cm.rmsnorm(x, cpu_model.final_norm, cfg.norm_eps)
            top = cm.head_apply(cfg, cpu_model.head, x, "torch")[0, -1].float(
                ).topk(2).values
        say(f"serve tokens {mode}: request {i} flips at step {step}: card "
            f"token {a[step]}, CPU token {b[step]}; the CPU run's top-1 "
            f"minus top-2 logit gap there {float(top[0] - top[1]):.3e}")
        raise AssertionError(f"greedy tokens differ ({mode}), request {i} "
                             f"step {step}")
    tier = (" (two replicas behind a Router, a torn-checkpoint swap on "
            "replica 0 mid-run, the prompts twice)" if mode == "router"
            else "")
    say(f"serve tokens {mode}: {cfg.name} float32, {len(prompts)} prompts of "
        f"{TOKEN_PROMPTS} tokens into 2 slots{tier}, chunks of 16, "
        f"{TOKEN_NEW} new "
        f"tokens each: kernels on {dev.type} and plain on the CPU give the "
        f"same greedy tokens ({sum(map(len, card))} tokens; preempted "
        f"{snap['preempted']}, spec ticks {snap['spec']['ticks']}; launches "
        f"on the card: sandwich {rose['sandwich_fwd']}, paged "
        f"{rose['paged_decode_attention']})")
    return snap


# the serving tier's full-width run through the CLI (phase 6d)
CLI_SERVE = dict(replicas=2, slots=SLOTS, max_len=MAX_LEN, requests=32,
                 min_prompt=5, max_prompt=200, max_new=NEW_TOKENS, rate=10.0)


def _tier_rates(doc) -> dict:
    """Decode tok/s of both replicas together (their decode tokens over their
    decode seconds, build ticks inside) and the mean engine tick (the
    ``serve_tick_seconds`` histogram) of one CLI run's telemetry
    document."""
    per = [p["engine"] for p in doc["summary"]["per_replica"]]
    toks = sum(e["decode_tokens"] for e in per)
    secs = sum(e["decode_tokens"] / e["decode_tok_per_s"] for e in per
               if e["decode_tok_per_s"])
    ticks = doc["metrics"]["metrics"]["serve_tick_seconds"]["samples"]
    n = sum(s["value"]["count"] for s in ticks)
    return {"tok_s": toks / secs if secs else 0.0,
            "tick_ms": sum(s["value"]["sum"] for s in ticks) * 1e3 / max(1, n),
            "ticks": n}


def phase_serve_cli(torch, cfg, dev, sizes=CLI_SERVE) -> tuple:
    """Phase 6d: ``launch.serve.main`` in process over ``sizes``' tier, four
    times in turns: without a tracer, with one, with one, without (so the
    comparison does not ride on the order). Returns the launches summed
    over the runs and a summary."""
    import contextlib
    import gc
    import io

    from repro_torch.launch import serve as serve_cli
    from repro_torch.obs.validate import validate_chrome_trace
    out = ROOT / "build" / "serve_cli"
    out.mkdir(parents=True, exist_ok=True)
    argv = ["--arch", cfg.name, "--device", dev.type, "--seed", "0",
            "--mix", "uniform"]
    for key in ("replicas", "slots", "requests", "min_prompt", "max_prompt",
                "rate"):
        argv += [f"--{key.replace('_', '-')}", str(sizes[key])]
    argv += ["--max-len", str(sizes["max_len"]), "--max-new",
             str(sizes["max_new"])]
    t_phase = time.monotonic()
    total, runs = {}, []
    for n, label in enumerate(("null", "tracer", "tracer", "null")):
        trace = out / f"trace_{n}.json"
        extra = ["--trace-out", str(trace)] if label == "tracer" else []
        gc.collect()          # the last run's garbage, not inside this one
        sync(torch, dev)
        zero_launches()
        text = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(text):
            doc = serve_cli.main(argv + extra + [
                "--metrics-json", str(out / f"metrics_{n}.json")])
        sync(torch, dev)
        wall = time.monotonic() - t0
        launches = read_launches()
        for line_ in text.getvalue().splitlines():
            if line_.startswith(("[serve] router", "  replica[")):
                say(f"serve cli run {n} ({label}): {line_.strip()}")
        snap = doc["summary"]
        dead = [p["dead"] for p in snap["per_replica"] if p["dead"]]
        if snap["requests_finished"] != sizes["requests"] or dead:
            raise AssertionError(f"serve cli run {n}: "
                                 f"{snap['requests_finished']} of "
                                 f"{sizes['requests']} requests finished, "
                                 f"dead replicas {dead}")
        want = {}
        for p in snap["per_replica"]:
            for k, v in serve_launches_want(cfg, p["engine"],
                                            dev.type == "cuda").items():
                want[k] = want.get(k, 0) + v
        if launches != want:
            raise AssertionError(f"serve cli run {n}: launches {launches}, "
                                 f"expected {want} (both replicas' ticks)")
        if extra:
            with open(trace) as f:
                events = validate_chrome_trace(json.load(f))
            finishes = sum(e["name"] == "finish" for e in events)
            if finishes != sizes["requests"]:
                raise AssertionError(f"serve cli run {n}: {finishes} finish "
                                     f"events for {sizes['requests']} "
                                     f"requests")
            say(f"serve cli run {n} ({label}): trace {len(events)} events, "
                f"valid")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        runs.append((label, snap, {**_tier_rates(doc), "wall_s": wall}))
    say(f"serve cli: {cfg.name} {cfg.compute_dtype}, {sizes['replicas']} "
        f"replicas x {sizes['slots']} slots, {sizes['requests']} requests "
        f"of {sizes['min_prompt']}-{sizes['max_prompt']} prompt tokens and "
        f"{sizes['max_new']} new, open loop at {sizes['rate']} req/s, "
        f"runs without, with, with, without a tracer:")
    for n, (label, snap, r) in enumerate(runs):
        say(f"serve cli run {n} ({label}): TTFT p50 "
            f"{snap['ttft_ms']['p50']} ms, p95 {snap['ttft_ms']['p95']} ms; "
            f"latency p50 {snap['latency_ms']['p50']} ms, p95 "
            f"{snap['latency_ms']['p95']} ms; dispatched "
            f"{[p['dispatched'] for p in snap['per_replica']]}; decode "
            f"tok/s of both replicas {r['tok_s']:.1f} (build ticks inside); "
            f"mean tick {r['tick_ms']:.3f} ms over {r['ticks']} ticks; wall "
            f"{r['wall_s']:.3f} s")

    def mean(label, key):
        vals = [r[key] for lab, _, r in runs if lab == label]
        return sum(vals) / len(vals)
    say(f"serve cli: decode tok/s with a tracer {mean('tracer', 'tok_s'):.1f}"
        f", without {mean('null', 'tok_s'):.1f}; mean tick "
        f"{mean('tracer', 'tick_ms'):.3f} ms with, "
        f"{mean('null', 'tick_ms'):.3f} ms without (means of two runs each, "
        f"not held); launches {total}; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    out_summary = {"cli_phase_s": time.monotonic() - t_phase,
                   "cli_tok_s_tracer": mean("tracer", "tok_s"),
                   "cli_tok_s_null": mean("null", "tok_s"),
                   "cli_tick_ms_tracer": mean("tracer", "tick_ms"),
                   "cli_tick_ms_null": mean("null", "tick_ms")}
    for n, (label, snap, _) in enumerate(runs):
        out_summary[f"cli_run{n}_{label}"] = {
            "ttft_ms": snap["ttft_ms"], "latency_ms": snap["latency_ms"],
            "dispatched": [p["dispatched"] for p in snap["per_replica"]]}
    return total, out_summary


def phase_serve_tokens(torch, np, dev) -> None:
    """:func:`serve_tokens_case` for every configuration of
    ``TOKEN_CASES``."""
    for mode in TOKEN_CASES:
        serve_tokens_case(torch, np, dev, mode)


def sandwich_ops(spec) -> tuple:
    """(forward, backward) operations per row of one sandwich site, counted
    on the support the function needs, not densely.

    Input side (stage s, stride 2^s, applied s-th): X[s] holds the nonzeros
    of stage s's input (x is n_in wide in n1), D[s] the positions there
    that reach the k1 selected outputs. Output side (stage p2-1-j applied
    j-th): V[j] holds the nonzeros of its input (from the k2 scattered
    values), G[j] the positions that reach the n_out live columns. The
    forward computes stage outputs on D and on V ∩ G. The backward
    recomputes the stage inputs it reads, takes each dual stage on the same
    sets (the cotangent of the output chain is needed on V, of the input
    chain it is nonzero on D) and forms a weight product, a multiply and an
    add into the sum over rows, wherever a nonzero cotangent meets a
    nonzero stage input. The core: 2·k1·k2 forward, 4·k1·k2 backward, and
    the scales."""
    import numpy as np

    def stage_ops(src, need, stride: int) -> int:
        """One stage (either direction) producing the elements ``need``
        from an input whose nonzeros are ``src`` (boolean masks): a
        multiply for each nonzero term, an add where an element has two."""
        partner = src[np.arange(src.size) ^ stride]
        return int((need & src).sum() + (need & partner).sum()
                   + (need & src & partner).sum())

    n1, n2 = spec.pad_in, spec.pad_out
    p1, p2 = int(math.log2(n1)), int(math.log2(n2))
    a1, a2 = np.arange(n1), np.arange(n2)
    X = [a1 < spec.n_in]
    for s in range(p1):
        X.append(X[-1] | X[-1][a1 ^ (1 << s)])
    D = [np.isin(a1, spec.idx_in)]
    for s in reversed(range(p1)):
        D.insert(0, D[0] | D[0][a1 ^ (1 << s)])
    st = [1 << (p2 - 1 - j) for j in range(p2)]
    V = [np.isin(a2, spec.idx_out)]
    for j in range(p2):
        V.append(V[-1] | V[-1][a2 ^ st[j]])
    G = [a2 < spec.n_out]
    for j in reversed(range(p2)):
        G.insert(0, G[0] | G[0][a2 ^ st[j]])
    k1, k2 = spec.k_in, spec.k_out
    in_fwd = sum(stage_ops(X[s], D[s + 1], 1 << s) for s in range(p1))
    out_fwd = [stage_ops(V[j], V[j + 1] & G[j + 1], st[j])
               for j in range(p2)]
    fwd = in_fwd + 2 * k1 * k2 + k1 + k2 + sum(out_fwd)
    live = D[0] & X[0]                           # dx on the n_in columns
    bwd = (in_fwd + 2 * k1 * k2 + k1 + k2 + sum(out_fwd[:-1])
           + 4 * k1 * k2 + k1 + k2)
    for j in range(p2):
        bwd += stage_ops(G[j + 1], V[j] & G[j], st[j])
        bwd += 2 * int((V[j] & G[j + 1]).sum()
                       + (V[j] & G[j + 1][a2 ^ st[j]]).sum())
    for s in range(p1):
        bwd += stage_ops(D[s + 1], live if s == 0 else D[s], 1 << s)
        bwd += 2 * int((D[s + 1] & X[s]).sum()
                       + (D[s + 1] & X[s][a1 ^ (1 << s)]).sum())
    return fwd, bwd


def sandwich_bound(spec, rows: int, dtype: str):
    """(bytes, ops) of one sandwich call: activations in and out once,
    float32 weights once; :func:`sandwich_ops` per row."""
    itemsize = 2 if dtype == "bfloat16" else 4
    n1, n2 = spec.pad_in, spec.pad_out
    p1, p2 = int(math.log2(n1)), int(math.log2(n2))
    nbytes = (rows * (spec.n_in + spec.n_out) * itemsize
              + 4 * (2 * p1 * n1 + 2 * p2 * n2 + spec.k_in * spec.k_out
                     + spec.k_in + spec.k_out))
    return nbytes, rows * sandwich_ops(spec)[0]


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_timing(torch, cfg, dev, kernel, time_fn, device_fn, launches,
                 errs, train_rows: int) -> list:
    """Times of the forward kernels. The sandwich: its two
    kernels together, the factor kernel alone, the plain twin, the bound
    and, as the library yardstick, one ``torch.matmul`` by its dense (n_in,
    n_out) matrix (materialized outside the timed window, in the compute
    dtype), over a decode tick's site mix at 8 rows and a train step's
    forward at ``train_rows``, with the bound at both, by CUDA events. The
    paged kernel at PAGED_SHAPES (:func:`time_paged`): its device time and
    SDPA's, which the kernels line carries, beside their event figures."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    dt = cfg.compute_dtype
    gen = torch.Generator().manual_seed(3)
    mix = {"up_gate": 2 * cfg.n_layers, "down": cfg.n_layers, "lm_head": 1}
    keys = ("ms", "factors_ms", "plain_ms", "bound_ms", "library_ms",
            "train_ms", "train_bound_ms", "train_library_ms")
    tick = dict.fromkeys(keys, 0.0)
    for key in ("bytes", "ops", "train_bytes", "train_ops"):
        tick[key] = 0
    with torch.no_grad():
        for site, count in mix.items():
            spec, layer = sandwich_site(torch, cfg, site, dev)
            x = torch.randn(SLOTS, spec.n_in, generator=gen).to(
                dev, getattr(torch, dt))
            ms = time_fn(torch, lambda: sandwich_call(
                torch, spec, layer, x, kernel), reps=200)
            fac = time_fn(torch, lambda: ks.sandwich_factors(
                layer.b_in, layer.b_out, layer.idx_in, layer.idx_out,
                n_in=spec.n_in, n_out=spec.n_out, dtype=x.dtype,
                backend=kernel), reps=200)
            plain = time_fn(torch, lambda: sandwich_call(
                torch, spec, layer, x, "torch"), reps=20)
            eye = torch.eye(spec.n_in, device=dev)
            dense = sandwich_call(torch, spec, layer, eye, "torch").to(x.dtype)
            lib = time_fn(torch, lambda: torch.matmul(x, dense), reps=200)
            xt = torch.randn(train_rows, spec.n_in, generator=gen).to(
                dev, getattr(torch, dt))
            ms_t = time_fn(torch, lambda: sandwich_call(
                torch, spec, layer, xt, kernel), reps=5)
            lib_t = time_fn(torch, lambda: torch.matmul(xt, dense), reps=5)
            del eye, dense, xt
            nbytes, ops = sandwich_bound(spec, SLOTS, dt)
            bnd, _ = bound_ms(nbytes, ops, PEAK_OPS["float32"])
            t_bytes, t_ops = sandwich_bound(spec, train_rows, dt)
            t_bnd, t_by = bound_ms(t_bytes, t_ops, PEAK_OPS["float32"])
            say(f"time sandwich {site:8s} rows={SLOTS} {dt}: kernels "
                f"{ms:.4f} ms (factors alone {fac:.4f}), plain {plain:.4f} "
                f"ms, matmul by the dense matrix {lib:.4f} ms, bound "
                f"{bnd:.5f} ms ({nbytes} B, {ops} ops); rows={train_rows}: "
                f"kernels {ms_t:.4f} ms, matmul {lib_t:.4f} ms, bound "
                f"{t_bnd:.5f} ms ({t_by}: {t_bytes} B, {t_ops} ops); x{count}"
                f" per decode tick and train step")
            for key, val in (("ms", ms), ("factors_ms", fac),
                             ("plain_ms", plain), ("bound_ms", bnd),
                             ("library_ms", lib), ("train_ms", ms_t),
                             ("train_bound_ms", t_bnd),
                             ("train_library_ms", lib_t)):
                tick[key] += count * val
            tick["bytes"] += count * nbytes
            tick["ops"] += count * ops
            tick["train_bytes"] += count * t_bytes
            tick["train_ops"] += count * t_ops
        _, by = bound_ms(tick["bytes"], tick["ops"], PEAK_OPS["float32"])
        _, t_by = bound_ms(tick["train_bytes"], tick["train_ops"],
                           PEAK_OPS["float32"])
        say(f"time sandwich per decode tick ({sum(mix.values())} calls of "
            f"{ks.FWD_KERNELS} launches): kernels {tick['ms']:.4f} ms "
            f"(factors alone {tick['factors_ms']:.4f}), plain "
            f"{tick['plain_ms']:.4f} ms, matmul {tick['library_ms']:.4f} ms, "
            f"bound {tick['bound_ms']:.5f} ms ({by}); per train step's "
            f"forward at {train_rows} rows: kernels {tick['train_ms']:.4f} "
            f"ms, matmul {tick['train_library_ms']:.4f} ms, bound "
            f"{tick['train_bound_ms']:.5f} ms ({t_by})")

        paged = {}
        for shape in PAGED_SHAPES:
            paged[shape[0]] = time_paged(torch, cfg, dev, kernel, time_fn,
                                         device_fn, shape)
    p = paged[PAGED_SHAPES[0][0]]
    long_p = paged[PAGED_SHAPES[1][0]]

    return [
        {"name": "sandwich_fwd (sandwich_factors + sandwich_rows)",
         "counter": "sandwich_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/sandwich.cu",
         "replaces": "src/repro/kernels/sandwich.py:75",
         "launches": launches["sandwich_fwd"],
         "max_abs_err": errs["sandwich_fwd"],
         "ms": tick["ms"], "plain_ms": tick["plain_ms"],
         "bound_ms": tick["bound_ms"], "bound_by": by,
         "library_ms": tick["library_ms"],
         "factors_ms": tick["factors_ms"], "train_ms": tick["train_ms"],
         "train_bound_ms": tick["train_bound_ms"], "train_bound_by": t_by,
         "train_library_ms": tick["train_library_ms"],
         "per": f"decode tick: {sum(mix.values())} calls of "
                f"{ks.FWD_KERNELS} launches at {SLOTS} rows (library: "
                f"torch.matmul by the dense matrix); train_*: a train "
                f"step's forward mix at {train_rows} rows"},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:92",
         "launches": launches["paged_decode_attention"],
         "max_abs_err": errs["paged_decode_attention"],
         "ms": p["ms"], "event_ms": p["event_ms"], "plain_ms": p["plain_ms"],
         "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
         "library_ms": p["library_ms"],
         "library_event_ms": p["library_event_ms"],
         "long_ms": long_p["ms"], "long_bound_ms": long_p["bound_ms"],
         "long_library_ms": long_p["library_ms"],
         "per": f"call ({pa.PAGED_KERNELS} launches), device time: "
                f"B={SLOTS}, {p['live']} live positions (library: sdpa over "
                f"KV gathered beforehand); long_*: {long_p['live']} live "
                f"positions"},
    ]


def time_paged(torch, cfg, dev, kernel, time_fn, device_fn, shape) -> dict:
    """The paged kernel at one of PAGED_SHAPES in the compute dtype: device
    time per call (``device_fn``) and the CUDA-event figure (``time_fn``)
    of the kernel and of the yardstick, one ``scaled_dot_product_attention``
    over KV gathered and head-expanded beforehand (not timed); the plain
    twin by events; the bound from the live rows' bytes."""
    from repro_torch.kernels import paged_attention as pa
    dt = cfg.compute_dtype
    q, k_pool, v_pool, ids, cur = paged_inputs(
        torch, cfg, getattr(torch, dt), dev, shape=shape)

    def call():
        return pa.paged_decode_attention(q, k_pool, v_pool, ids, cur,
                                         backend=kernel)

    r = {"ms": device_fn(torch, call, reps=200),
         "event_ms": time_fn(torch, call, reps=500),
         "plain_ms": time_fn(torch, lambda: pa.paged_decode_attention(
             q, k_pool, v_pool, ids, cur, backend="torch"), reps=20)}
    B, KV, G, D = q.shape
    L = ids.shape[1] * k_pool.shape[1]

    def heads(pool):       # head = kv * G + g
        kv = pa.gather_pages(pool, ids).permute(0, 2, 1, 3)
        return kv.repeat_interleave(G, dim=1).contiguous()

    kg, vg = heads(k_pool), heads(v_pool)
    mask = (torch.arange(L, device=dev)[None, :]
            <= cur[:, None].long())[:, None, None, :]
    qh = q.reshape(B, KV * G, 1, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    r["library_ms"] = device_fn(torch, lambda: sdpa(qh, kg, vg,
                                                    attn_mask=mask), reps=200)
    r["library_event_ms"] = time_fn(torch, lambda: sdpa(
        qh, kg, vg, attn_mask=mask), reps=500)
    live = int((cur.long() + 1).sum())
    itemsize = q.element_size()
    nbytes = (2 * q.numel() * itemsize + 2 * live * KV * D * itemsize
              + ids.numel() * 4 + cur.numel() * 4)
    ops = 4 * live * KV * G * D
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, ops, PEAK_OPS[dt])
    r["live"] = live
    say(f"time paged {shape[0]} B={B} P={ids.shape[1]} live positions={live}"
        f" {dt}: kernel {r['ms']:.5f} ms device ({r['event_ms']:.5f} ms by "
        f"events over back-to-back calls), plain {r['plain_ms']:.4f} ms, sdpa "
        f"{r['library_ms']:.5f} ms device ({r['library_event_ms']:.5f} by "
        f"events), bound {r['bound_ms']:.5f} ms ({r['bound_by']}: {nbytes} B,"
        f" {ops} ops); x{cfg.n_layers} per decode tick{clocks(dev)}")
    return r


def profile_window(torch, dev, fn, ticks: int):
    """``torch.profiler`` over ``ticks`` calls of ``fn``: wall ms per call,
    and the device-side events (kernels, copies) as (name, device us,
    count); the host ops that launch them carry the same device time
    again, so they are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        sync(torch, dev)
        t0 = time.monotonic()
        for _ in range(ticks):
            fn()
        sync(torch, dev)
        wall_us = (time.monotonic() - t0) * 1e6
    events = [(e.key, e.self_device_time_total, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    return wall_us, events


# the kernels a graphed decode tick must show in its device trace
GRAPHED_KERNELS = ("sandwich_factors_kernel", "sandwich_rows_kernel",
                   "paged_split_kernel", "paged_combine_kernel")


def phase_profile(torch, np, cfg, dev) -> dict:
    """Where a pooled decode tick's time goes, graphed and eager:
    ``torch.profiler`` over three decode ticks of 8 slots (prompts of 5
    tokens) replayed from the engine's decode graph, then over three of
    the same ticks run eagerly through the kernels (``decode_logits``,
    which also copies the KV pool once a call); device time by kernel and
    the device-busy share of the ticks' wall time. Each sandwich and paged
    kernel's launches a tick in the graphed window's device trace must
    equal the decode graph's launches per replay. Returns the
    per-tick wall and busy ms and device launches of both windows ({}
    where the profiler saw no device time)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.graphs import format_key
    eng = ServeEngine(cfg, model_of(cfg, dev), slots=SLOTS, max_len=MAX_LEN,
                      prefill_chunk=CHUNK, device=dev)
    rng = np.random.default_rng(4)
    for _ in range(SLOTS):
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab_size, 5),
                           max_new_tokens=NEW_TOKENS))
    eng.step()          # prefill + first decode: both graphs built
    eng.step()          # the first decode replay
    ticks, out = 3, {}
    windows = (("graphed", eng.step),
               ("eager", lambda: eng.decode_logits(backend="cuda")))
    for name, fn in windows:
        if name == "eager" and dev.type != "cuda":
            continue
        wall_us, events = profile_window(torch, dev, fn, ticks)
        busy_us = sum(e[1] for e in events)
        if not busy_us:
            say(f"profile {name}: device time not measured")
            return {}
        n = sum(e[2] for e in events) // ticks
        say(f"profile {name}: {ticks} decode ticks, wall "
            f"{wall_us / ticks / 1e3:.3f} ms/tick, device busy "
            f"{busy_us / ticks / 1e3:.3f} ms/tick "
            f"({100 * busy_us / wall_us:.1f}% of wall), {n} device "
            f"launches/tick")
        for key, us, count in sorted(events, key=lambda e: -e[1])[:8]:
            say(f"profile {name}: {us / ticks / 1e3:8.3f} ms/tick "
                f"{count // ticks:5d} launches/tick  {key[:90]}")
        if name == "graphed":
            # each kernel's launches a tick in the replayed ticks' device
            # trace against the decode graph's launches per replay, which
            # the counters add back at each replay: the trace shows that
            # every replay ran them
            lpr = eng.graphs.stats()[format_key(eng._decode_entry().key)][
                "launches_per_replay"]
            seen = {k: sum(e[2] for e in events if k in e[0]) / ticks
                    for k in GRAPHED_KERNELS}
            want = {k: lpr[c] / n for k, (c, n) in zip(GRAPHED_KERNELS, (
                ("sandwich_fwd", ks.FWD_KERNELS),) * 2 + ((
                    "paged_decode_attention", pa.PAGED_KERNELS),) * 2)}
            say(f"profile graphed: launches a tick in the device trace "
                f"{seen}, the decode graph's launches per replay {lpr}")
            if seen != want:
                raise AssertionError(f"the graphed decode ticks' device "
                                     f"trace shows {seen} launches a tick, "
                                     f"the decode graph holds {want}")
            if dev.type == "cuda":
                # the decode graph replayed back to back (its K/V writes at
                # cur_pos repeat the same values): the device's span of a
                # replay, gaps between its nodes included
                entry = eng._decode_entry()
                span = cuda_ms(torch, lambda: eng.graphs.run(entry), 20)
                # one replay alone, as a tick runs it: the host's time in
                # the launch call, then the wait until the device is done
                launch, wait = [], []
                for _ in range(10):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng.graphs.run(entry)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    launch.append(t1 - t0)
                    wait.append(time.perf_counter() - t1)
                launch_ms = 1e3 * sorted(launch)[5]
                wait_ms = 1e3 * sorted(wait)[5]
                say(f"profile graphed: one replay of the decode graph "
                    f"{span:.3f} ms by CUDA events over 20 back-to-back "
                    f"replays; one replay alone (median of 10, host clock) "
                    f"{launch_ms:.3f} ms in the launch call, then "
                    f"{wait_ms:.3f} ms until the device is done")
                out.update({"profile_replay_ms": span,
                            "profile_replay_launch_ms": launch_ms,
                            "profile_replay_wait_ms": wait_ms})
        tag = "" if name == "graphed" else "eager_"
        out.update({f"profile_{tag}wall_ms_per_tick": wall_us / ticks / 1e3,
                    f"profile_{tag}busy_ms_per_tick": busy_us / ticks / 1e3,
                    f"profile_{tag}launches_per_tick": n})
    return out


# -- training (slice 2) -------------------------------------------------------

GRAD_TOL = {"float32": 1e-5, "bfloat16": 0.08}   # fraction of max|want|
BWD_ROWS = 256            # kernel-vs-plain rows per site, besides the
                          # training run's rows (the row loops of a block)
HEAD_BWD_ROWS = 2048      # at most, at the head: the plain twin's autograd
                          # keeps ~20 stage activations of 65,536 floats a row
TRAIN_STEPS = (2, 5)      # warm, timed
LEAF_TOL = 5e-2           # per butterfly leaf, relative norm
STEP_F32_TOL = 1e-3       # per butterfly leaf of a whole float32 step


def grad_close_or_raise(torch, what, got, want, dtype) -> tuple:
    """Max |got - want| and its share of max|want|; raises unless |got - want| <= frac·max|want| +
    frac·|want| everywhere (float32 frac 1e-5, bfloat16 0.08: the
    reference's gradient tolerances) and ``got`` is finite."""
    got, want = got.float(), want.float()
    frac = GRAD_TOL[dtype]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel gradient is not finite")
    err = (got - want).abs()
    limit = frac * max(float(want.abs().max()), 1e-3) + frac * want.abs()
    if not bool((err <= limit).all()):
        raise AssertionError(f"{what}: max |err| {float(err.max()):.3e} "
                             f"beyond {frac} of max|want| "
                             f"{float(want.abs().max()):.3e} "
                             f"({int((err > limit).sum())} of {err.numel()} "
                             f"outside)")
    return float(err.max()), float(err.max()) / float(want.abs().max())


def sandwich_bwd_call(torch, spec, layer, x, g, backend):
    from repro_torch.kernels import sandwich as ks
    return ks.sandwich_backward(
        x, layer.b_in, layer.core, layer.b_out, layer.idx_in, layer.idx_out,
        g, scale_in=spec.scale_in, scale_out=spec.scale_out,
        n_out=spec.n_out, backend=backend)


def check_sandwich_bwd(torch, dev, what, spec, layer, x, g, kernel: str,
                       dtype: str) -> list:
    """The backward kernel against its plain twin on (x, g): two launches
    bit-identical, each gradient within GRAD_TOL; prints one line, returns
    [(max|err|, share of max|want|)] for dx, d b_in, d core, d b_out."""
    names = ("dx", "d b_in", "d core", "d b_out")
    got = sandwich_bwd_call(torch, spec, layer, x, g, kernel)
    again = sandwich_bwd_call(torch, spec, layer, x, g, kernel)
    want = sandwich_bwd_call(torch, spec, layer, x, g, "torch")
    sync(torch, dev)
    errs = []
    for name, a, b, w in zip(names, got, again, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} {name}: two launches differ")
        errs.append(grad_close_or_raise(torch, f"{what} {name}", a, w, dtype))
    say(f"{what} max|err| (share of max|want|) "
        + " ".join(f"{n.replace(' ', '')} {e:.3e} ({r:.1e})"
                   for n, (e, r) in zip(names, errs))
        + f"; tol {GRAD_TOL[dtype]} of max|want|; repeat bit-identical")
    return errs


def check_factors_vjp(torch, dev, what, spec, layer, kernel: str, gen
                      ) -> None:
    """The factor-row VJP (the backward's kernels 3 and 4 alone) against its
    twin, autograd through ``sandwich_factors_plain``, for random
    cotangents of F_in and F_out, with the weights rounded to each dtype:
    two launches bit-identical, within GRAD_TOL["float32"] (both are
    float32; only the summation order differs)."""
    from repro_torch.kernels import sandwich as ks
    d_f_in = torch.randn(spec.k_in, spec.n_in, generator=gen).to(dev)
    d_f_out = torch.randn(spec.k_out, spec.n_out, generator=gen).to(dev)
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        got, again, want = (ks.sandwich_factors_vjp(
            layer.b_in.detach(), layer.b_out.detach(), layer.idx_in,
            layer.idx_out, d_f_in, d_f_out, dtype=dtype, backend=b)
            for b in (kernel, kernel, "torch"))
        sync(torch, dev)
        for name, a, b, w in zip(("d b_in", "d b_out"), got, again, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{what} {name}: two launches differ")
            errs.append(grad_close_or_raise(
                torch, f"{what} {str(dtype)[6:]} {name}", a, w, "float32"))
    say(f"{what} max|err| (share of max|want|) "
        + " ".join(f"{n} {e:.3e} ({r:.1e})" for n, (e, r) in zip(
            ("db_in f32", "db_out f32", "db_in bf16", "db_out bf16"), errs))
        + f"; tol {GRAD_TOL['float32']} of max|want|; repeat bit-identical")


def phase_sandwich_bwd(torch, cfg, dev, kernel: str, train_rows: int
                       ) -> float:
    """The backward kernels against their plain twin at the three
    full-width sites, float32 and bfloat16, at BWD_ROWS rows and at the
    training run's ``train_rows`` (the head at no more than HEAD_BWD_ROWS),
    where the column kernel splits the rows; two launches on the same
    inputs must give bit-identical gradients. Then the factor-row VJP alone
    against its twin at each site."""
    worst = 0.0
    gen = torch.Generator().manual_seed(11)
    cases = [(site, rows, dtype) for site in sites(cfg)
             for rows in sorted({BWD_ROWS, train_rows if site != "lm_head"
                                 else min(train_rows, HEAD_BWD_ROWS)})
             for dtype in ("float32", "bfloat16")]
    with torch.no_grad():
        for site, rows, dtype in cases:
            spec, layer = sandwich_site(torch, cfg, site, dev)
            dt = getattr(torch, dtype)
            x = torch.randn(rows, spec.n_in, generator=gen).to(dev, dt)
            g = torch.randn(rows, spec.n_out, generator=gen).to(dev, dt)
            errs = check_sandwich_bwd(
                torch, dev, f"sandwich_bwd {site:8s} rows={rows:4d} "
                f"{dtype:9s}", spec, layer, x, g, kernel, dtype)
            if dtype == cfg.compute_dtype:
                worst = max(worst, *(e for e, _ in errs))
        for site in sites(cfg):
            spec, layer = sandwich_site(torch, cfg, site, dev)
            check_factors_vjp(torch, dev, f"sandwich factors vjp {site:8s}",
                              spec, layer, kernel, gen)
    return worst


def phase_wide(torch, dev, kernel: str, wide=WIDE, rows: int = WIDE_ROWS
               ) -> None:
    """The sandwich kernels at ``wide`` (name, n_in, n_out), past the smollm
    sites' widths: the spec from ``make_spec`` (k = log2 n), the layer's own
    weights, ``rows`` rows; the forward against ``sandwich_plain`` at
    SANDWICH_TOL and the backward against ``sandwich_bwd_plain`` at
    GRAD_TOL (two launches bit-identical), float32 and bfloat16, and the
    factor-row VJP against its twin."""
    from repro_torch.core import layers as blayers
    from repro_torch.nn import ButterflyLinear
    name, n_in, n_out = wide
    gen = torch.Generator().manual_seed(14)
    spec = blayers.make_spec(gen, n_in, n_out, use_bias=False)
    layer = ButterflyLinear(spec, generator=gen).to(dev)
    head = (f"{name} {n_in}->{n_out} (n1 {spec.pad_in}, n2 {spec.pad_out}, "
            f"k {spec.k_in}/{spec.k_out}) rows={rows}")
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x = torch.randn(rows, n_in, generator=gen).to(dev, dt)
            g = torch.randn(rows, n_out, generator=gen).to(dev, dt)
            got = sandwich_call(torch, spec, layer, x, kernel)
            want = sandwich_call(torch, spec, layer, x, "torch")
            sync(torch, dev)
            err = allclose_or_raise(torch, f"sandwich {head} {dtype}", got,
                                    want, SANDWICH_TOL[dtype])
            say(f"sandwich {head} {dtype:9s} max|err|={err:.3e} (tol "
                f"{SANDWICH_TOL[dtype]})")
            del got, want
            check_sandwich_bwd(torch, dev, f"sandwich_bwd {head} {dtype:9s}",
                               spec, layer, x, g, kernel, dtype)
        check_factors_vjp(torch, dev, f"sandwich factors vjp {head}", spec,
                          layer, kernel, gen)


def phase_sandwich_bwd_bench(torch, dev, kernel: str, n: int,
                             rows: int = 64) -> None:
    """The backward kernel against its plain twin at ``bench_backward``'s
    widest sandwich, n -> n with k = log2 n at its batch of 64 rows (at n =
    8192 the input side's checkpoints live in device memory), float32 and
    bfloat16, two launches bit-identical."""
    from repro_torch.core import layers as blayers
    from repro_torch.nn import ButterflyLinear
    k = max(2, int(math.log2(n)))
    gen = torch.Generator().manual_seed(12)
    spec = blayers.make_spec(gen, n, n, k_in=k, k_out=k, use_bias=False)
    layer = ButterflyLinear(spec, generator=gen).to(dev)
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x = torch.randn(rows, n, generator=gen).to(dev, dt)
            g = torch.randn(rows, n, generator=gen).to(dev, dt)
            check_sandwich_bwd(torch, dev, f"sandwich_bwd bench n={n} k={k} "
                               f"rows={rows} {dtype:9s}", spec, layer, x, g,
                               kernel, dtype)


def train_counts(cfg) -> tuple:
    """Sandwich forward and backward launches per train step: every site
    once forward (two kernels: factors, rows) and once backward (six
    kernels: factors, rows, columns, their sum, factor-row VJP, reduction),
    and with remat the 90 MLP sites (the checkpointed layers) once more
    forward inside the backward pass."""
    from repro_torch.kernels import sandwich as ks
    sites_per_step = 3 * cfg.n_layers + 1
    return (ks.FWD_KERNELS * (sites_per_step
                              + (3 * cfg.n_layers if cfg.remat else 0)),
            ks.BWD_KERNELS * sites_per_step)


def phase_train(torch, np, cfg, dev, seq_len: int, batch: int) -> tuple:
    """The training main path: Trainer on ``cfg`` from seed 0, TrainConfig
    defaults with warmup_steps=2, TRAIN_STEPS warm and timed steps; counts
    set to 0 just before and read just after. Returns (launches, summary)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import sandwich as ks
    from repro_torch.train.trainer import Trainer
    warm, timed = TRAIN_STEPS
    trainer = Trainer(cfg, TrainConfig(warmup_steps=2), seq_len=seq_len,
                      global_batch=batch, device=dev)
    model, opt_state = trainer.init_state(seed=0)
    on_card = dev.type == "cuda"
    sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    ks.sandwich_forward.launches = 0
    ks.sandwich_backward.launches = 0
    res = trainer.run(warm + timed, model=model, opt_state=opt_state)
    sync(torch, dev)
    launches = {"sandwich_fwd": ks.sandwich_forward.launches,
                "sandwich_bwd": ks.sandwich_backward.launches}
    fwd, bwd = train_counts(cfg)
    steps = warm + timed
    want = {"sandwich_fwd": on_card * fwd * steps,
            "sandwich_bwd": on_card * bwd * steps}
    if launches != want:
        raise AssertionError(f"train launch counts {launches}, expected "
                             f"{want}")
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"non-finite training loss: {res.losses}")
    ms = sorted(1e3 * t for t in res.step_times[warm:])
    p50 = ms[len(ms) // 2]
    tokens = seq_len * batch
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    say(f"train: {cfg.name}, {cfg.n_layers} layers, seq_len {seq_len} x "
        f"batch {batch} = {tokens} tokens/step, remat {cfg.remat}, "
        f"{warm} warm + {timed} timed steps; step ms p50 {p50:.1f} (min "
        f"{ms[0]:.1f}, max {ms[-1]:.1f}); {tokens / p50 * 1e3:.0f} tokens/s; "
        f"peak memory {peak / 2**20:.1f} MiB; straggler EMA "
        f"{1e3 * res.step_time_ema:.1f} ms")
    say(f"train: losses {' '.join(f'{v:.4f}' for v in res.losses)}")
    say(f"train: launches {launches} = ({fwd} fwd, {bwd} bwd) per step x "
        f"{steps} steps")
    summary = {"train_step_ms_p50": p50,
               "train_tokens_per_s": tokens / p50 * 1e3,
               "train_peak_mib": peak / 2**20, "train_losses": res.losses}
    summary.update(profile_train_step(torch, trainer, model, opt_state,
                                      dev))
    return launches, summary


def profile_train_step(torch, trainer, model, opt_state, dev) -> dict:
    """Device time of one more train step by kernel, ``torch.profiler``;
    {} where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        return {}
    batch = trainer._batch(trainer.data.batch(0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync(torch, dev)
        t0 = time.monotonic()
        trainer.step_fn(model, opt_state, batch)
        sync(torch, dev)
        wall_us = (time.monotonic() - t0) * 1e6
    events = [(e.key, e.self_device_time_total, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e[1] for e in events)
    if not busy_us:
        say("profile train: device time not measured")
        return {}
    # the factor kernel serves the forward and the backward alike: its time
    # is split between them by their launches (train_counts)
    from repro_torch.kernels import sandwich as ks
    fwd_n, bwd_n = train_counts(trainer.cfg)
    fac_fwd, fac_bwd = fwd_n // ks.FWD_KERNELS, bwd_n // ks.BWD_KERNELS
    fac_us = sum(e[1] for e in events if "sandwich_factors" in e[0])
    fac_n = sum(e[2] for e in events if "sandwich_factors" in e[0])
    bwd_us = (sum(e[1] for e in events if "sandwich_bwd" in e[0])
              + fac_us * fac_bwd / (fac_fwd + fac_bwd))
    fwd_us = (sum(e[1] for e in events if "sandwich_rows" in e[0])
              + fac_us * fac_fwd / (fac_fwd + fac_bwd))
    say(f"profile train: one step, wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{sum(e[2] for e in events)} device launches; sandwich backward "
        f"kernels {bwd_us / 1e3:.3f} ms, forward {fwd_us / 1e3:.3f} ms (the "
        f"factor kernel's {fac_us / 1e3:.3f} ms over {fac_n} launches split "
        f"{fac_fwd}:{fac_bwd} by launches)")
    for key, us, count in sorted(events, key=lambda e: -e[1])[:10]:
        say(f"profile train: {us / 1e3:9.3f} ms {count:6d} launches  "
            f"{key[:90]}")
    for key, us, count in sorted(events, key=lambda e: -e[1]):
        if "sandwich" in key:
            say(f"profile train sandwich: {us / 1e3:8.3f} ms {count:5d} "
                f"launches {us / count:8.2f} us each  {key[:70]}")
    return {"train_profile_wall_ms": wall_us / 1e3,
            "train_profile_busy_ms": busy_us / 1e3,
            "train_profile_sandwich_bwd_ms": bwd_us / 1e3,
            "train_profile_sandwich_fwd_ms": fwd_us / 1e3}


def phase_train_gradcheck(torch, np, cfg, dev, kernel: str) -> None:
    """One train step's gradients layer by layer (global_batch 1, seq_len
    256): a plain forward and backward gives each layer's input and the
    cotangent of its output; each layer, and the final norm, head and loss,
    then runs under ``kernel`` and under the plain versions on that input
    and cotangent. Every butterfly leaf (b_in, core, b_out of each site)
    must be finite and within LEAF_TOL of the plain gradient in relative
    norm of the difference, for the serving check's reason: rounding
    differences of a correct kernel compound through the stack after it.
    The whole step's loss and leaf gradients through both paths are
    printed, not held."""
    from repro_torch.data.pipeline import for_model
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.train import steps
    model = lm.LM(cfg, generator=torch.Generator().manual_seed(1)).to(dev)
    raw = for_model(cfg, 256, 1, seed=1).batch(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    S = batch["tokens"].shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None]

    def head_loss(x, backend):
        h = cm.rmsnorm(x, model.final_norm, cfg.norm_eps)
        logits = cm.head_apply(cfg, model.head, h, backend)
        return cm.cross_entropy(logits[:, :-1], batch["targets"][:, 1:],
                                batch["mask"][:, 1:])

    # the plain path: each layer's input and its output's cotangent
    with torch.no_grad():
        xs = [cm.embed(cfg, model.embed, batch["tokens"])]
    ins, outs = [], []
    for layer in model.layers:
        ins.append(xs[-1].detach().requires_grad_())
        outs.append(lm.layer_apply(cfg, layer, ins[-1], positions=positions,
                                   backend="torch"))
        xs.append(outs[-1].detach())
    last = xs[-1].detach().requires_grad_()
    (cot,) = torch.autograd.grad(head_loss(last, "torch"), last)
    cots = [cot]                      # cots[i]: cotangent of layer i's output
    for i in reversed(range(1, cfg.n_layers)):
        (g,) = torch.autograd.grad(outs[i], ins[i], grad_outputs=cots[0])
        cots.insert(0, g)
    del ins, outs

    def leaves(module, prefix):
        return {f"{prefix}.{n}": p for n, p in module.named_parameters()
                if n.endswith(("b_in", "core", "b_out"))}

    rel, plain = {}, {}
    for i, layer in enumerate(model.layers):
        ps = leaves(layer.ffn, f"layers.{i}.ffn")
        grads = []
        for backend in (kernel, "torch"):
            out = lm.layer_apply(cfg, layer, xs[i], positions=positions,
                                 backend=backend)
            grads.append(torch.autograd.grad(out, list(ps.values()),
                                             grad_outputs=cots[i]))
        for name, gk, gp in zip(ps, *grads):
            if not bool(torch.isfinite(gk).all()):
                raise AssertionError(f"train gradcheck {name}: not finite")
            rel[name] = float((gk - gp).norm() / gp.norm())
            plain[name] = gp
    ps = leaves(model.head, "head")
    gk, gp = (torch.autograd.grad(head_loss(xs[-1], b), list(ps.values()))
              for b in (kernel, "torch"))
    for name, a, b in zip(ps, gk, gp):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"train gradcheck {name}: not finite")
        rel[name] = float((a - b).norm() / b.norm())
        plain[name] = b
    worst = max(rel, key=rel.get)
    say(f"train gradcheck, layer by layer on the plain path's inputs and "
        f"cotangents: {len(rel)} butterfly leaves, relative norm of the "
        f"difference max {rel[worst]:.3e} ({worst}), median "
        f"{sorted(rel.values())[len(rel) // 2]:.3e}; tol {LEAF_TOL}")
    # the whole step through both paths, for the record only
    (lk, gwk), (lp, gwp) = (steps.loss_and_grads(model, batch, backend=b)
                            for b in (kernel, "torch"))
    whole = [float((gwk[n] - gwp[n]).norm() / gwp[n].norm()) for n in rel]
    # the layer-by-layer plain gradients are the whole plain step's
    drift = max(float((plain[n] - gwp[n]).norm() / gwp[n].norm())
                for n in rel)
    if not drift <= 1e-2:
        raise AssertionError(f"train gradcheck: layer-by-layer plain "
                             f"gradients differ from the whole step's by "
                             f"{drift:.3e}")
    say(f"train gradcheck, whole step through all {cfg.n_layers} layers "
        f"(not held): loss {float(lk):.6f} vs {float(lp):.6f} (diff "
        f"{abs(float(lk) - float(lp)):.3e}); leaf relative norm max "
        f"{max(whole):.3e}, median {sorted(whole)[len(whole) // 2]:.3e}; "
        f"plain layer-by-layer vs whole-step gradients {drift:.1e}")
    bad = {n: r for n, r in rel.items() if not r <= LEAF_TOL}
    if bad:
        raise AssertionError(f"train gradcheck: {len(bad)} leaves beyond "
                             f"{LEAF_TOL}: {dict(list(bad.items())[:5])}")


def phase_train_step_f32(torch, cfg, dev, kernel: str) -> None:
    """The gradient check's whole train step (same weights and batch) in
    float32 compute, through ``kernel`` and through the plain versions.
    Without bfloat16's rounding points the differences of a correct kernel
    stay near float32 rounding through all the layers, so each butterfly
    leaf must be finite and within STEP_F32_TOL of the plain gradient in
    relative norm; a fault that shows only on the kernel path's own
    activations would not stay there. The other leaves are printed."""
    from repro_torch.data.pipeline import for_model
    from repro_torch.models import lm
    from repro_torch.train import steps
    cfg32 = cfg.with_(compute_dtype="float32")
    model = lm.LM(cfg32, generator=torch.Generator().manual_seed(1)).to(dev)
    raw = for_model(cfg32, 256, 1, seed=1).batch(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    (lk, gk), (lp, gp) = (steps.loss_and_grads(model, batch, backend=b)
                          for b in (kernel, "torch"))
    rel = {n: float((gk[n] - gp[n]).norm()
                    / gp[n].norm().clamp_min(1e-30)) for n in gp}
    leaves = [n for n in rel if n.endswith(("b_in", "core", "b_out"))]
    others = [n for n in rel if n not in leaves]
    worst = max(leaves, key=rel.get)
    say(f"train step float32, whole step through all {cfg.n_layers} layers, "
        f"kernels vs plain: loss {float(lk):.6f} vs {float(lp):.6f} (diff "
        f"{abs(float(lk) - float(lp)):.3e}); {len(leaves)} butterfly leaves, "
        f"relative norm of the difference max {rel[worst]:.3e} ({worst}), "
        f"median {sorted(rel[n] for n in leaves)[len(leaves) // 2]:.3e}; "
        f"tol {STEP_F32_TOL}; other leaves max "
        f"{max(rel[n] for n in others):.3e}")
    for n in leaves:
        if not bool(torch.isfinite(gk[n]).all()):
            raise AssertionError(f"train step float32 {n}: not finite")
    bad = {n: rel[n] for n in leaves if not rel[n] <= STEP_F32_TOL}
    if bad:
        raise AssertionError(f"train step float32: {len(bad)} leaves beyond "
                             f"{STEP_F32_TOL}: {dict(list(bad.items())[:5])}")


def sandwich_bwd_bound(spec, rows: int, dtype: str):
    """(bytes, ops) of one backward call: x, g read and dx written once,
    float32 weights read and their gradients written once; per row the
    recompute and the VJP on the support they need (:func:`sandwich_ops`)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    n1, n2 = spec.pad_in, spec.pad_out
    p1, p2 = int(math.log2(n1)), int(math.log2(n2))
    weights = 2 * p1 * n1 + 2 * p2 * n2 + spec.k_in * spec.k_out
    nbytes = (rows * (2 * spec.n_in + spec.n_out) * itemsize
              + 4 * 2 * weights + 4 * (spec.k_in + spec.k_out))
    return nbytes, rows * sandwich_ops(spec)[1]


def phase_timing_bwd(torch, cfg, dev, kernel, time_fn, launches, err,
                     train_rows: int) -> dict:
    """CUDA-event times of the backward over one train step's site mix: the
    kernels, the plain twin, the bound and the dense layer's backward at
    BWD_ROWS rows (the plain twin cannot take the head at the training
    run's rows), and the kernels, the bound and the dense backward at the
    training run's ``train_rows``. The dense backward, the yardstick the
    port never calls, is ``dx = g·W`` and ``dW = gᵀ·x`` by ``torch.matmul``
    with W (n_out, n_in) the sandwich materialized in the compute dtype
    outside the timed window. ``launches`` counts kernels, BWD_KERNELS per
    call."""
    from repro_torch.kernels import sandwich as ks
    dt = cfg.compute_dtype
    gen = torch.Generator().manual_seed(13)
    mix = {"up_gate": 2 * cfg.n_layers, "down": cfg.n_layers, "lm_head": 1}
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "train_ms",
            "train_bound_ms", "train_library_ms")
    step = dict.fromkeys(keys, 0.0)
    step.update(bytes=0, ops=0, train_bytes=0, train_ops=0)
    with torch.no_grad():
        for site, count in mix.items():
            spec, layer = sandwich_site(torch, cfg, site, dev)

            def inputs(rows):
                return (torch.randn(rows, spec.n_in, generator=gen).to(
                    dev, getattr(torch, dt)),
                    torch.randn(rows, spec.n_out, generator=gen).to(
                    dev, getattr(torch, dt)))

            eye = torch.eye(spec.n_in, device=dev)
            w = sandwich_call(torch, spec, layer, eye, "torch").T.contiguous(
                ).to(getattr(torch, dt))
            del eye

            def dense(x, g):
                return torch.matmul(g, w), torch.matmul(g.T, x)

            x, g = inputs(BWD_ROWS)
            ms = time_fn(torch, lambda: sandwich_bwd_call(
                torch, spec, layer, x, g, kernel), reps=20)
            plain = time_fn(torch, lambda: sandwich_bwd_call(
                torch, spec, layer, x, g, "torch"), reps=5)
            lib = time_fn(torch, lambda: dense(x, g), reps=20)
            nbytes, ops = sandwich_bwd_bound(spec, BWD_ROWS, dt)
            bnd, by = bound_ms(nbytes, ops, PEAK_OPS["float32"])
            xf, gf = inputs(train_rows)
            full = time_fn(torch, lambda: sandwich_bwd_call(
                torch, spec, layer, xf, gf, kernel), reps=10)
            lib_t = time_fn(torch, lambda: dense(xf, gf), reps=10)
            fbytes, fops = sandwich_bwd_bound(spec, train_rows, dt)
            fbnd, fby = bound_ms(fbytes, fops, PEAK_OPS["float32"])
            del xf, gf, w
            say(f"time sandwich_bwd {site:8s} {dt}: rows={BWD_ROWS} kernels "
                f"{ms:.4f} ms, plain {plain:.4f} ms, dense backward "
                f"{lib:.4f} ms, bound {bnd:.5f} ms ({by}); rows={train_rows} "
                f"kernels {full:.4f} ms, dense backward {lib_t:.4f} ms, bound "
                f"{fbnd:.5f} ms ({fby}: {fbytes} B, {fops} ops); x{count} per "
                f"train step")
            for key, val in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bnd), ("library_ms", lib),
                             ("train_ms", full), ("train_bound_ms", fbnd),
                             ("train_library_ms", lib_t)):
                step[key] += count * val
            step["bytes"] += count * nbytes
            step["ops"] += count * ops
            step["train_bytes"] += count * fbytes
            step["train_ops"] += count * fops
    _, by = bound_ms(step["bytes"], step["ops"], PEAK_OPS["float32"])
    _, t_by = bound_ms(step["train_bytes"], step["train_ops"],
                       PEAK_OPS["float32"])
    say(f"time sandwich_bwd per train step ({sum(mix.values())} calls of "
        f"{ks.BWD_KERNELS} launches): rows={BWD_ROWS} kernels "
        f"{step['ms']:.4f} ms, plain {step['plain_ms']:.4f} ms, dense "
        f"backward {step['library_ms']:.4f} ms, bound {step['bound_ms']:.5f} "
        f"ms ({by}); rows={train_rows} kernels {step['train_ms']:.4f} ms, "
        f"dense backward {step['train_library_ms']:.4f} ms, bound "
        f"{step['train_bound_ms']:.5f} ms ({t_by})")
    return {"name": "sandwich_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/sandwich_bwd.cu",
            "replaces": "src/repro/kernels/sandwich.py:89",
            "launches": launches, "max_abs_err": err,
            "ms": step["ms"], "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"], "bound_by": by,
            "library_ms": step["library_ms"],
            "train_ms": step["train_ms"],
            "train_bound_ms": step["train_bound_ms"], "train_bound_by": t_by,
            "train_library_ms": step["train_library_ms"],
            "per": f"train step: {sum(mix.values())} calls of "
                   f"{ks.BWD_KERNELS} launches (factors, rows, columns, "
                   f"their sum, factor-row VJP, reduction; the factor kernel "
                   f"from src/repro_torch/csrc/sandwich_factors.cuh) at "
                   f"{BWD_ROWS} rows "
                   f"(library: the dense layer's backward, dx = g·W and dW "
                   f"= gT·x by torch.matmul); train_*: the same at "
                   f"{train_rows} rows"}


# -- the encoder-decoder (slice 3) --------------------------------------------

MNIST = (784, 70000, 32)      # n (28 x 28 pixels, padded to 1024), d, k
TWO_PHASE_STEPS = (400, 300)  # bench_two_phase.py: lr 3e-3, then 1e-3
# (name, rows, n) of the butterfly kernels against their plain twins: the
# encoder's product, Olivetti faces (400 images of 64 x 64), fewer rows than
# blocks, a row count that the chunks do not divide, n = 8192 (checkpoints
# in device memory) and the widest n (every working row there)
BFLY_SHAPES = (("mnist", 70000, 1024), ("olivetti", 400, 4096),
               ("few_rows", 5, 1024), ("ragged", 1237, 2048),
               ("n8192", 300, 8192), ("n32768", 64, 32768))
BFLY_TOL = {"float32": 1e-5, "bfloat16": 5e-2}   # fractions of max|want|


def close_to_max_or_raise(torch, what, got, want, frac) -> tuple:
    """Max |got - want| and its share of max|want|; raises unless it is
    within frac·max|want| + frac·|want| everywhere and ``got`` is
    finite."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (got - want).abs()
    limit = frac * max(float(want.abs().max()), 1e-3) + frac * want.abs()
    if not bool((err <= limit).all()):
        raise AssertionError(f"{what}: max |err| {float(err.max()):.3e} "
                             f"beyond {frac} of max|want| "
                             f"{float(want.abs().max()):.3e} "
                             f"({int((err > limit).sum())} of {err.numel()} "
                             f"outside)")
    return float(err.max()), float(err.max()) / max(
        float(want.abs().max()), 1e-30)


def butterfly_case(torch, rows, n, dtype, dev, seed):
    from repro_torch.core import butterfly as bf
    gen = torch.Generator().manual_seed(seed)
    w = bf.random_weights(gen, n).to(dev)
    x = torch.randn(rows, n, generator=gen).to(dev, getattr(torch, dtype))
    g = torch.randn(rows, n, generator=gen).to(dev, getattr(torch, dtype))
    return x, w, g


def phase_butterfly(torch, dev, kernel: str, shapes) -> dict:
    """The butterfly kernels against their plain twins at ``shapes``, both
    directions, float32 and bfloat16: the forward; the backward with and
    without dx, two launches bit-identical and dw the same without dx; the
    kernel's stage-application count for the first row equal to
    ``stage_applies(p, ⌈√p⌉)`` and at most 3p. Returns the worst float32
    max|err| of the forward and of dw."""
    from repro_torch.kernels import butterfly as kb
    on_card = dev.type == "cuda"
    worst = {"butterfly_fwd": 0.0, "butterfly_bwd": 0.0}
    seed = 20
    for name, rows, n in shapes:
        p = int(math.log2(n))
        want_applied = kb.stage_applies(p)
        if want_applied > 3 * p:
            raise AssertionError(f"stage_applies({p}) = {want_applied} > 3p")
        for transpose in (False, True):
            for dtype in ("float32", "bfloat16"):
                seed += 1
                what = (f"butterfly {name} {rows}x{n} "
                        f"{'Bt' if transpose else 'B '} {dtype}")
                frac = BFLY_TOL[dtype]
                x, w, g = butterfly_case(torch, rows, n, dtype, dev, seed)
                with torch.no_grad():
                    got = kb.butterfly_forward(x, w, transpose=transpose,
                                               backend=kernel)
                    want = kb.butterfly_forward(x, w, transpose=transpose,
                                                backend="torch")
                sync(torch, dev)
                e_fwd = close_to_max_or_raise(torch, what, got, want, frac)
                del got, want
                applied = torch.zeros(1, dtype=torch.int32, device=dev)
                dx, dw = kb.butterfly_backward(x, w, g, transpose=transpose,
                                               backend=kernel,
                                               applied=applied)
                dx2, dw2 = kb.butterfly_backward(x, w, g,
                                                 transpose=transpose,
                                                 backend=kernel)
                none, dw3 = kb.butterfly_backward(
                    x, w, g, transpose=transpose, need_dx=False,
                    backend=kernel)
                pdx, pdw = kb.butterfly_backward(
                    x, w, g, transpose=transpose, backend="torch")
                sync(torch, dev)
                if not (torch.equal(dw, dw2) and torch.equal(dx, dx2)):
                    raise AssertionError(f"{what}: two backward launches "
                                         f"differ")
                if none is not None or not torch.equal(dw, dw3):
                    raise AssertionError(f"{what}: the backward without dx "
                                         f"gives another dw")
                e_dx = close_to_max_or_raise(torch, f"{what} dx", dx, pdx,
                                             frac)
                e_dw = close_to_max_or_raise(torch, f"{what} dw", dw, pdw,
                                             frac)
                got_applied = int(applied) if on_card else want_applied
                if got_applied != want_applied:
                    raise AssertionError(f"{what}: the kernel applied "
                                         f"{got_applied} stages for its "
                                         f"first row, stage_applies gives "
                                         f"{want_applied}")
                say(f"{what:38s} max|err| (share of max|want|) "
                    + " ".join(f"{k} {e:.3e} ({r:.1e})" for k, (e, r) in
                               (("fwd", e_fwd), ("dx", e_dx), ("dw", e_dw)))
                    + f"; tol {frac} of max|want|; dw bit-identical (repeat,"
                      f" no dx); stage applications {got_applied} (3p = "
                      f"{3 * p})")
                if name == "mnist" and dtype == "float32" and not transpose:
                    worst["butterfly_fwd"] = max(worst["butterfly_fwd"],
                                                 e_fwd[0])
                    worst["butterfly_bwd"] = max(worst["butterfly_bwd"],
                                                 e_dw[0])
                del x, w, g, dx, dw, dx2, dw2, dw3, pdx, pdw
    return worst


def encdec_setup(torch, dev, shape, seed=0):
    """The MNIST-shape problem: the stand-in data, a spec and params from
    seeds, as ``launch.encdec`` sets them up."""
    from repro_torch.core import encdec as ed
    from repro_torch.data.synthetic import synthetic_image_matrix
    n, d, k = shape
    t0 = time.monotonic()
    X_np = synthetic_image_matrix(n, d, seed)
    say(f"encdec data: synthetic_image_matrix({n}, {d}, {seed}) in "
        f"{time.monotonic() - t0:.1f} s")
    X = torch.from_numpy(X_np).to(dev)
    spec = ed.make_spec(torch.Generator().manual_seed(seed), n=n, d=d, k=k)
    params = ed.init_params(torch.Generator().manual_seed(seed + 1), spec,
                            device=dev)
    return spec, params, X


def encdec_step_p50(torch, spec, params, X, dev, train_B, reps=10):
    """p50 ms of one train step (host clock, synchronised): ``reps`` calls
    of one step each."""
    from repro_torch.core import encdec as ed
    ts = []
    for _ in range(reps):
        sync(torch, dev)
        t0 = time.monotonic()
        ed.train(spec, params, X, X, steps=1, lr=1e-3, train_B=train_B)
        sync(torch, dev)
        ts.append(1e3 * (time.monotonic() - t0))
    return sorted(ts)[len(ts) // 2]


def phase_encdec(torch, dev, shape, steps) -> tuple:
    """The encoder-decoder main path at ``shape``: the Theorem 1 row (the
    closed form against the prediction, rtol 1e-3), FJLT+PCA, and the
    two-phase row (``steps`` of phase 1 and 2 with the bench's rates) with
    the counts set to 0 just before and read just after; every loss finite,
    phase 1 no better than the prediction, phase 2 within 2% of phase 1 or
    better, launches as the design implies. Returns (launches, summary,
    (spec, params, X))."""
    from repro_torch.core import encdec as ed
    from repro_torch.kernels import butterfly as kb
    from repro_torch.launch import encdec as launch
    on_card = dev.type == "cuda"
    spec, params, X = encdec_setup(torch, dev, shape)
    n, d, k = shape
    t0 = time.monotonic()
    th = launch.theorem1_row(spec, params, X)
    fjlt = float(ed.fjlt_pca_loss(torch.Generator().manual_seed(2), X, k,
                                  spec.ell))
    sync(torch, dev)
    say(f"encdec n={n} (pad {spec.pad_n}) d={d} k={k} ell={spec.ell}: "
        f"closed-form loss {th['measured']:.4f}, theorem1_loss "
        f"{th['predicted']:.4f}, rel_err {th['rel_err']:.3e} (tol 1e-3); "
        f"fjlt_pca_loss {fjlt:.4f} ({time.monotonic() - t0:.1f} s)")
    if not th["rel_err"] <= 1e-3:
        raise AssertionError(f"closed-form loss {th['measured']} is not the "
                             f"Theorem 1 prediction {th['predicted']}")
    s1, s2 = steps
    sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    kb.butterfly_forward.launches = 0
    kb.butterfly_backward.launches = 0
    t0 = time.monotonic()
    row = launch.two_phase_row(spec, params, X, steps1=s1, steps2=s2,
                               log_every=1)
    sync(torch, dev)
    wall = time.monotonic() - t0
    launches = {"butterfly_fwd": kb.butterfly_forward.launches,
                "butterfly_bwd": kb.butterfly_backward.launches}
    # a forward per step of both phases, and for the prediction and the two
    # final losses; phase 1 leaves B out of the gradient, so backward
    # launches come from phase 2 only
    want = {"butterfly_fwd": on_card * (s1 + s2 + 3),
            "butterfly_bwd": on_card * kb.BWD_KERNELS * s2}
    if launches != want:
        raise AssertionError(f"encdec launch counts {launches}, expected "
                             f"{want}")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    losses = row["h1"] + row["h2"] + [row["phase1"], row["phase2"],
                                      row["thm1_prediction"], row["pca"]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite encdec loss: {row['derived']}")
    pred = row["thm1_prediction"]
    if not row["phase1"] >= pred * (1 - 1e-3):
        raise AssertionError(f"phase 1 loss {row['phase1']} beats the "
                             f"global optimum {pred}")
    if not row["phase2"] <= row["phase1"] * 1.02:
        raise AssertionError(f"phase 2 loss {row['phase2']} above phase 1 "
                             f"{row['phase1']} x 1.02")
    p50 = {b: encdec_step_p50(torch, spec, params, X, dev, b)
           for b in (False, True)}
    say(f"encdec {row['name']}: {row['derived']}; fjlt_pca={fjlt:.4f}")
    say(f"encdec two-phase: {s1} + {s2} steps in {wall:.2f} s; step ms p50 "
        f"phase 1 {p50[False]:.3f}, phase 2 {p50[True]:.3f} (one-step "
        f"calls, host clock, synchronised); peak memory "
        f"{peak / 2**20:.1f} MiB; launches {launches} = {s1 + s2} + 3 "
        f"forward, {kb.BWD_KERNELS} x {s2} backward")
    summary = {"encdec_closed_loss": th["measured"],
               "encdec_theorem1_loss": pred, "encdec_pca_loss": row["pca"],
               "encdec_fjlt_pca_loss": fjlt,
               "encdec_phase1_loss": row["phase1"],
               "encdec_phase2_loss": row["phase2"],
               "encdec_two_phase_wall_s": wall,
               "encdec_step_ms_p50_phase1": p50[False],
               "encdec_step_ms_p50_phase2": p50[True],
               "encdec_peak_mib": peak / 2**20}
    return launches, summary, (spec, params, X)


def phase_encdec_vs_plain(torch, dev, kernel, spec, params, X) -> None:
    """Kernels against the plain versions on the whole path, float32: one
    loss gradient (B, E, D each within 1e-4 in relative norm of the
    difference) and the losses of 10 phase-2 steps (rtol 1e-4)."""
    from repro_torch.core import encdec as ed
    grads = {}
    for backend in (kernel, "torch"):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = ed.loss_fn(spec, leaves, X, X, backend=backend)
        grads[backend] = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
    rel = {k: float((grads[kernel][k] - grads["torch"][k]).norm()
                    / grads["torch"][k].norm()) for k in params}
    hist = {b: ed.train(spec, params, X, X, steps=10, lr=1e-3, train_B=True,
                        log_every=1, backend=b)[1] for b in (kernel, "torch")}
    worst = max(abs(a - b) / abs(b) for a, b in zip(hist[kernel],
                                                    hist["torch"]))
    say(f"encdec kernels vs plain: gradient relative norm of the difference "
        f"{' '.join(f'{k} {v:.2e}' for k, v in rel.items())} (tol 1e-4); "
        f"10 phase-2 steps, losses {hist[kernel][0]:.4f} .. "
        f"{hist[kernel][-1]:.4f}, max rel diff {worst:.2e} (tol 1e-4)")
    bad = {k: v for k, v in rel.items() if not v <= 1e-4}
    if bad:
        raise AssertionError(f"encdec gradients beyond 1e-4: {bad}")
    if not worst <= 1e-4:
        raise AssertionError(f"encdec 10-step losses differ: {hist}")


def butterfly_bound(rows: int, n: int, itemsize: int, backward: bool,
                    need_dx: bool = False):
    """(bytes, ops) of one butterfly call: the activations in and out once,
    float32 weights read once (and dw written once); 3 operations per
    element and stage application, and in the backward 4 per element and
    stage for the two weight products, :func:`stage_applies` stages."""
    from repro_torch.kernels import butterfly as kb
    p = int(math.log2(n))
    wbytes = 4 * 2 * p * n
    if not backward:
        return 2 * rows * n * itemsize + wbytes, rows * 3 * n * p
    nbytes = (2 + need_dx) * rows * n * itemsize + 2 * wbytes
    return nbytes, rows * (3 * n * kb.stage_applies(p) + 4 * n * p)


def phase_timing_butterfly(torch, dev, kernel, time_fn, device_fn, launches,
                           errs, shape, shapes) -> list:
    """Times at the encoder's product, float32, as the path calls them (B x
    forward, the backward without dx): each kernel, its plain twin and, for
    the forward, one ``torch.matmul`` of x by the materialized B
    (materialized outside the timed window) as a yardstick the port never
    calls, all by device time (``device_fn``) beside their CUDA-event
    figures (``time_fn``); each kernel's bound. Then both kernels by device
    time at every shape of ``shapes`` (float32, B x, without dx)."""
    from repro_torch.core import butterfly as bf
    from repro_torch.kernels import butterfly as kb
    n = 1 << (shape[0] - 1).bit_length()
    rows = shape[1]
    x, w, g = butterfly_case(torch, rows, n, "float32", dev, seed=40)
    Bm = bf.materialize(w)
    calls = {
        "fwd": (lambda: kb.butterfly_forward(x, w, backend=kernel), 20),
        "fwd_plain": (lambda: kb.butterfly_forward(x, w, backend="torch"),
                      5),
        "matmul": (lambda: torch.matmul(x, Bm.T), 5),
        "bwd": (lambda: kb.butterfly_backward(x, w, g, need_dx=False,
                                              backend=kernel), 10),
        "bwd_plain": (lambda: kb.butterfly_backward(
            x, w, g, need_dx=False, backend="torch"), 3)}
    t = {}
    with torch.no_grad():     # the plain backward enables its own autograd
        for name, (fn, reps) in calls.items():
            t[name] = (device_fn(torch, fn, reps=reps),
                       time_fn(torch, fn, reps=reps))
    clk = clocks(dev)
    del Bm
    fb, fo = butterfly_bound(rows, n, 4, backward=False)
    bb, bo = butterfly_bound(rows, n, 4, backward=True)
    bnd_f, by_f = bound_ms(fb, fo, PEAK_OPS["float32"])
    bnd_b, by_b = bound_ms(bb, bo, PEAK_OPS["float32"])
    (ms_f, ev_f), (plain_f, plain_ev_f), (lib_f, lib_ev_f) = (
        t["fwd"], t["fwd_plain"], t["matmul"])
    (ms_b, ev_b), (plain_b, plain_ev_b) = t["bwd"], t["bwd_plain"]
    say(f"time butterfly_fwd {rows}x{n} float32: kernel {ms_f:.4f} ms device "
        f"({ev_f:.4f} ms by events), plain {plain_f:.4f} ms ({plain_ev_f:.4f}"
        f"), matmul by materialized B {lib_f:.4f} ms ({lib_ev_f:.4f}; "
        f"{2 * rows * n * n} flop), bound {bnd_f:.5f} ms ({by_f}: {fb} B, "
        f"{fo} ops){clk}")
    say(f"time butterfly_bwd {rows}x{n} float32 without dx: kernel "
        f"{ms_b:.4f} ms device ({ev_b:.4f} ms by events; {kb.BWD_KERNELS} "
        f"launches), plain {plain_b:.4f} ms ({plain_ev_b:.4f}), no library "
        f"call, bound {bnd_b:.5f} ms ({by_b}: {bb} B, {bo} ops){clk}")
    del x, w, g
    for name, srows, sn in shapes:
        x, w, g = butterfly_case(torch, srows, sn, "float32", dev, seed=41)
        with torch.no_grad():
            sf = device_fn(torch, lambda: kb.butterfly_forward(
                x, w, backend=kernel), reps=10)
            sb = device_fn(torch, lambda: kb.butterfly_backward(
                x, w, g, need_dx=False, backend=kernel), reps=10)
        say(f"time butterfly {name} {srows}x{sn} float32: forward {sf:.4f} "
            f"ms, backward without dx {sb:.4f} ms (device)")
        del x, w, g
    per = f"launch: {rows} rows x n {n}, float32"
    return [
        {"name": "butterfly_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/butterfly.cu",
         "replaces": "src/repro/kernels/butterfly.py:96",
         "launches": launches["butterfly_fwd"],
         "max_abs_err": errs["butterfly_fwd"], "ms": ms_f,
         "plain_ms": plain_f, "bound_ms": bnd_f, "bound_by": by_f,
         "library_ms": lib_f, "event_ms": ev_f,
         "library_event_ms": lib_ev_f,
         "launches_by_path": {"encdec": launches["butterfly_fwd"]},
         "per": per},
        {"name": "butterfly_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/butterfly_bwd.cu",
         "replaces": "src/repro/kernels/butterfly.py:168",
         "launches": launches["butterfly_bwd"],
         "max_abs_err": errs["butterfly_bwd"], "ms": ms_b,
         "plain_ms": plain_b, "bound_ms": bnd_b, "bound_by": by_b,
         "library_ms": None, "event_ms": ev_b,
         "launches_by_path": {"encdec": launches["butterfly_bwd"]},
         "per": f"call of {kb.BWD_KERNELS} launches without dx: {rows} rows "
                f"x n {n}, float32"},
    ]


# -- flash attention and the benches (slice 4) --------------------------------

# (name, B, H, S, D, dtypes, causal, window), besides (a) the training
# attention, which :func:`run` takes from the config (seq_len 2048 x batch
# 4, 9 heads from 3 KV heads expanded, head_dim 64, bf16, causal): (b)
# bench_backward's flash rows, (c) a gemma3-27b local layer
# (configs/gemma3_27b.py), (d) ragged and wide, (e) the narrowest and a
# wide head under the asymmetric non-causal window
FLASH_SHAPES = (
    ("bench_s1024", 1, 2, 1024, 64, ("float32",), True, 0),
    ("bench_s8192", 1, 2, 8192, 64, ("float32",), True, 0),
    ("gemma3_local", 1, 32, 4096, 128, ("bfloat16",), True, 1024),
    ("ragged_d256", 2, 3, 1000, 256, ("float32",), False, 0),
    ("d8_window", 2, 3, 77, 8, ("float32", "bfloat16"), False, 24),
    ("d192_window", 2, 3, 77, 192, ("float32", "bfloat16"), False, 24),
)
# timed besides (a); the first is the bench path's widest flash call, whose
# numbers the kernels line reports
FLASH_TIMED = ("bench_s8192",)
# fractions of max|want|: float32 sums run in another order; bfloat16
# rounds once at the output
FLASH_FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
FLASH_LSE_TOL = 1e-5
FLASH_GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# bfloat16 is held row by row besides: each row of o and dq, each key's row
# of dk and dv, within 1% of its own norm (one bf16 step is at most 2^-7 of
# a value), so that a small row cannot pass against the tensor's largest
FLASH_ROW_TOL = 1e-2
# the bench path's rows against the plain versions on their own inputs, all
# float32: (output, gradients) as fractions of max|want|
BENCH_TOL = {"butterfly": (BFLY_TOL["float32"], BFLY_TOL["float32"]),
             "sandwich": (SANDWICH_TOL["float32"], GRAD_TOL["float32"]),
             "flash": (FLASH_FWD_TOL["float32"], FLASH_GRAD_TOL["float32"])}


def rows_close_or_raise(torch, what, got, want, rel) -> float:
    """The largest ‖got − want‖ over a row (the last dim) against the row's
    ‖want‖; raises unless every row is within rel·(‖want_row‖ + 1e-3·the
    largest ‖want_row‖, at least 1e-3, as close_to_max_or_raise floors
    it)."""
    err = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    scale = ref + 1e-3 * max(float(ref.max()), 1e-3)
    if not bool((err <= rel * scale).all()):
        raise AssertionError(f"{what}: {int((err > rel * scale).sum())} of "
                             f"{err.numel()} rows beyond {rel} of their norm "
                             f"(worst {float((err / scale).max()):.3e})")
    return float((err / scale).max())


def flash_inputs(torch, shape, dtype, dev, seed):
    """q, k, v, dO of one flash shape, standard normal from ``seed``."""
    _, B, H, S, D = shape[:5]
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(B, H, S, D, generator=gen).to(dev,
                                                      getattr(torch, dtype))
            for _ in range(4)]


def phase_flash(torch, dev, kernel: str, shapes) -> dict:
    """The three flash kernels against their plain twins at ``shapes``: o
    and lse of the forward; dq, dk, dv of the backward for one dO from the
    plain forward's o and lse, two launches bit-identical; in bfloat16 also
    row by row (FLASH_ROW_TOL). Returns {shape name: max|err|} in the
    shape's first dtype: the forward's, dq's, and the larger of dk's and
    dv's."""
    from repro_torch.kernels import flash as kf
    found = {}
    seed = 60
    for shape in shapes:
        name, B, H, S, D, dtypes, causal, window = shape
        for dtype in dtypes:
            seed += 1
            q, k, v, do = flash_inputs(torch, shape, dtype, dev, seed)
            kw = dict(causal=causal, window=window)
            what = (f"flash {name} B={B} H={H} S={S} D={D} {dtype} "
                    f"causal={causal} window={window}")
            out, lse = kf.flash_forward(q, k, v, backend=kernel, **kw)
            pout, plse = kf.flash_forward(q, k, v, backend="torch", **kw)
            sync(torch, dev)
            errs = {"o": close_to_max_or_raise(torch, f"{what} o", out, pout,
                                               FLASH_FWD_TOL[dtype]),
                    "lse": close_to_max_or_raise(torch, f"{what} lse", lse,
                                                 plse, FLASH_LSE_TOL)}
            by_row = {}
            if dtype == "bfloat16":
                by_row["o"] = rows_close_or_raise(torch, f"{what} o", out,
                                                  pout, FLASH_ROW_TOL)
            del out, lse
            got = kf.flash_backward(q, k, v, pout, plse, do, backend=kernel,
                                    **kw)
            again = kf.flash_backward(q, k, v, pout, plse, do,
                                      backend=kernel, **kw)
            want = kf.flash_backward(q, k, v, pout, plse, do,
                                     backend="torch", **kw)
            sync(torch, dev)
            for g, a, w, n in zip(got, again, want, ("dq", "dk", "dv")):
                if not torch.equal(g, a):
                    raise AssertionError(f"{what} {n}: two backward launches "
                                         f"differ")
                errs[n] = close_to_max_or_raise(torch, f"{what} {n}", g, w,
                                                FLASH_GRAD_TOL[dtype])
                if dtype == "bfloat16":
                    by_row[n] = rows_close_or_raise(torch, f"{what} {n}", g,
                                                    w, FLASH_ROW_TOL)
            say(f"{what}: max|err| (share of max|want|) "
                + " ".join(f"{n} {e:.3e} ({r:.1e})"
                           for n, (e, r) in errs.items())
                + f"; max|want| dq {float(want[0].abs().max()):.3e}; tol "
                  f"{FLASH_FWD_TOL[dtype]} / {FLASH_LSE_TOL} / "
                  f"{FLASH_GRAD_TOL[dtype]} of max|want|; backward "
                  f"bit-identical"
                + ("; worst row |err|/|want| " + " ".join(
                    f"{n} {r:.1e}" for n, r in by_row.items())
                   + f" (tol {FLASH_ROW_TOL})" if by_row else ""))
            if dtype == dtypes[0]:
                found[name] = {"flash_fwd": errs["o"][0],
                               "flash_bwd_dq": errs["dq"][0],
                               "flash_bwd_dkv": max(errs["dk"][0],
                                                    errs["dv"][0])}
            del q, k, v, do, pout, plse, got, again, want
    return found


def phase_flash_autograd(torch, dev, kernel: str, shape) -> None:
    """``FlashFn`` through ``torch.autograd.grad`` at ``shape``: the
    gradients of ``vdot(c, flash_attention(q, k, v))`` through the kernels
    against the same through the plain twins, at the flash tolerances (in
    bfloat16 also row by row); one forward and two backward launches per
    call."""
    from repro_torch.kernels import flash as kf
    name, B, H, S, D, (dtype, *_), causal, window = shape
    q, k, v, c = flash_inputs(torch, shape, dtype, dev, seed=80)
    on_card = dev.type == "cuda"
    grads = {}
    for backend in (kernel, "torch"):
        f0, b0 = kf.flash_forward.launches, kf.flash_backward.launches
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = kf.flash_attention(*leaves, causal=causal, window=window,
                                 backend=backend)
        grads[backend] = torch.autograd.grad((c.float() * out.float()).sum(),
                                             leaves)
        sync(torch, dev)
        rose = (kf.flash_forward.launches - f0,
                kf.flash_backward.launches - b0)
        want = (1, kf.BWD_KERNELS) if backend == "cuda" else (0, 0)
        if rose != want:
            raise AssertionError(f"flash_attention ({backend}): launches "
                                 f"rose by {rose}, expected {want}")
    names = ("dq", "dk", "dv")
    errs = [close_to_max_or_raise(torch, f"FlashFn {name} {n}", g, w,
                                  FLASH_GRAD_TOL[dtype])
            for n, g, w in zip(names, grads[kernel], grads["torch"])]
    by_row = ([rows_close_or_raise(torch, f"FlashFn {name} {n}", g, w,
                                   FLASH_ROW_TOL)
               for n, g, w in zip(names, grads[kernel], grads["torch"])]
              if dtype == "bfloat16" else [])
    say(f"FlashFn {name} {dtype} through autograd, kernels vs plain: "
        + " ".join(f"{n} {e:.3e} ({r:.1e})" for n, (e, r) in zip(names, errs))
        + ("; worst row |err|/|want| " + " ".join(
            f"{n} {r:.1e}" for n, r in zip(names, by_row))
           + f" (tol {FLASH_ROW_TOL})" if by_row else "")
        + f"; launches per call 1 + {kf.BWD_KERNELS}"
        + ("" if on_card else " (plain: 0)"))


def bench_want(rows, on_card: bool) -> dict:
    """The launches of every kernel that the timed calls of ``rows`` imply:
    ``kernel/*`` the butterfly forward; ``speed/*`` the sandwich forward (2
    launches), and its train step the sandwich backward (6); each fused
    ``backward/*`` step one forward and one backward call of its op."""
    from repro_torch.kernels import butterfly as kb
    from repro_torch.kernels import flash as kf
    from repro_torch.kernels import sandwich as ks
    calls = {}
    for r in rows:
        kind = r["name"].split("_n")[0]
        calls[kind] = calls.get(kind, 0) + r["calls"]
    bfly = calls.get("backward/butterfly_fwdbwd_fused", 0)
    sand = (calls.get("speed/train", 0)
            + calls.get("backward/sandwich_fwdbwd_fused", 0))
    flash = calls.get("backward/flash_fwdbwd_fused", 0)
    want = {"butterfly_fwd": calls.get("kernel/butterfly", 0) + bfly,
            "butterfly_bwd": kb.BWD_KERNELS * bfly,
            "sandwich_fwd": ks.FWD_KERNELS * (calls.get("speed/forward", 0)
                                              + sand),
            "sandwich_bwd": ks.BWD_KERNELS * sand,
            "flash_fwd": flash, "flash_bwd": kf.BWD_KERNELS * flash}
    return {k: on_card * v for k, v in want.items()}


def check_bench(torch, dev, kernel: str, checks) -> None:
    """Each kernel row of the bench path run once through ``kernel`` and
    once through the plain versions on that row's own inputs: the output,
    and a step's gradients, within BENCH_TOL."""
    for name, op, make in checks:
        got, want = make(kernel)(), make("torch")()
        sync(torch, dev)
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        if len(got) != len(want):
            raise AssertionError(f"bench {name}: {len(got)} results against "
                                 f"the plain version's {len(want)}")
        tol_out, tol_grad = BENCH_TOL[op]
        errs = [close_to_max_or_raise(
            torch, f"bench {name} {'out' if i == 0 else f'grad {i}'}", g, w,
            tol_out if i == 0 else tol_grad)
            for i, (g, w) in enumerate(zip(got, want))]
        say(f"bench {name} kernels vs plain, float32: max|err| (share of "
            f"max|want|) out {errs[0][0]:.3e} ({errs[0][1]:.1e})"
            + "".join(f", grad {i} {e:.3e} ({r:.1e})"
                      for i, (e, r) in enumerate(errs[1:], 1))
            + f"; tol {tol_out} / {tol_grad} of max|want|")
        del got, want


def phase_bench(torch, dev, kernel: str, bench: dict) -> dict:
    """The benches' main path: ``launch.speed.run`` at the reference's sizes
    (``bench`` may cut them for a rehearsal), with every launch counter set
    to 0 just before and read just after. Every reference row name must be
    present; on the card every row is timed and finite, and each kernel's
    launches are what the timed calls imply (:func:`bench_want`). Then
    every kernel row is held against the plain versions on its own inputs
    (:func:`check_bench`). Returns the launches by kernel."""
    from repro_torch.kernels import butterfly as kb
    from repro_torch.kernels import flash as kf
    from repro_torch.kernels import sandwich as ks
    from repro_torch.launch import speed
    on_card = dev.type == "cuda"
    counters = {"butterfly_fwd": kb.butterfly_forward,
                "butterfly_bwd": kb.butterfly_backward,
                "sandwich_fwd": ks.sandwich_forward,
                "sandwich_bwd": ks.sandwich_backward,
                "flash_fwd": kf.flash_forward,
                "flash_bwd": kf.flash_backward}
    sync(torch, dev)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.monotonic()
    checks = []
    rows = speed.run(dev, checks=checks, **bench)
    sync(torch, dev)
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    for r in rows:
        say("bench: " + speed.line(r))
    names = [r["name"] for r in rows]
    want_names = speed.row_names(ns=bench.get("ns"))
    if names != want_names:
        raise AssertionError(f"bench rows {names} are not the reference's "
                             f"{want_names}")
    for r in rows:
        us = r["us_per_call"]
        fused = "_fused_" in r["name"]
        if on_card and (us is None or not math.isfinite(us)):
            raise AssertionError(f"bench row {r['name']} not timed: {r}")
        if not on_card and fused and "reason=no_cuda" not in r["derived"]:
            raise AssertionError(f"bench row {r['name']}: {r['derived']}")
    want = bench_want(rows, on_card)
    if launches != want:
        raise AssertionError(f"bench launches {launches}, expected {want}")
    if on_card and not all(launches.values()):
        raise AssertionError(f"a kernel of the bench path never launched: "
                             f"{launches}")
    say(f"bench: {len(rows)} rows in {wall:.1f} s; launches {launches} as "
        f"the timed calls imply")
    check_bench(torch, dev, kernel, checks)
    return launches


def flash_pairs(S: int, causal: bool, window: int) -> int:
    """Visible (q, k) pairs of one head under the mask."""
    total = 0
    for q in range(S):
        hi = q + 1 if causal else S
        lo = max(0, q - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def flash_bound(shape, dtype: str):
    """{kernel: (bytes, ops)} of one call of each flash kernel: its inputs
    read once and outputs written once; 4·D (forward), 6·D (dq) and 8·D
    (dkv) operations per visible pair."""
    _, B, H, S, D, _, causal, window = shape
    item = 2 if dtype == "bfloat16" else 4
    arr, rows = B * H * S * D * item, B * H * S * 4
    pairs = B * H * flash_pairs(S, causal, window)
    return {"flash_fwd": (4 * arr + rows, 4 * D * pairs),
            "flash_bwd_dq": (5 * arr + 2 * rows, 6 * D * pairs),
            "flash_bwd_dkv": (6 * arr + 2 * rows, 8 * D * pairs)}


def phase_timing_flash(torch, dev, kernel, time_fn, device_fn, launches,
                       errs, shapes, entry: str, kv_heads: int) -> list:
    """Times of the three flash kernels at ``shapes`` (the training
    attention first): each kernel alone and SDPA's forward and backward by
    device time (``device_fn``) beside their CUDA-event figures
    (``time_fn``), the plain twins by CUDA events; each kernel's bound (in
    float32 at the 3xTF32 rate, the CUDA-core one printed beside it), and
    as the library yardstick the port never calls
    ``scaled_dot_product_attention(is_causal=True)``: its forward for the
    forward, its backward (fwd+bwd through ``torch.autograd.grad`` minus
    fwd) for the dq/dkv pair. At the first shape also the port's plain
    ``models.attention._attend_masked`` forward and fwd+bwd in grouped
    layout over ``kv_heads`` heads, without KV expansion. The kernels
    line's entries carry the numbers of the shape named ``entry``, where
    the bench path launches them, with ``errs[entry]`` from
    :func:`phase_flash`; the other shapes go in ``per``. The SDPA backward
    computes dq, dk and dv in one: it stands as ``library_ms`` of the dq
    entry, for the pair, and the dkv entry has none."""
    from repro_torch.kernels import flash as kf
    from repro_torch.models.attention import _attend_masked
    on_card = dev.type == "cuda"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dq_k = kf.dq_cuda if on_card else kf.flash_dq_plain
    dkv_k = kf.dkv_cuda if on_card else kf.flash_dkv_plain
    found = {}
    for shape in shapes:
        name, B, H, S, D, (dtype, *_), causal, window = shape
        q, k, v, do = flash_inputs(torch, shape, dtype, dev, seed=90)
        kw = dict(causal=causal, window=window)
        with torch.no_grad():
            out, lse = kf.flash_forward(q, k, v, backend=kernel, **kw)
            delta = kf.row_delta(out, do)
        reps = 10 if S >= 4096 else 20

        calls = {
            "flash_fwd": lambda: kf.flash_forward(q, k, v, backend=kernel,
                                                  **kw),
            "flash_bwd_dq": lambda: dq_k(q, k, v, do, lse, delta, **kw),
            "flash_bwd_dkv": lambda: dkv_k(q, k, v, do, lse, delta, **kw)}
        plains = {
            "flash_fwd": lambda: kf.flash_forward(q, k, v, backend="torch",
                                                  **kw),
            "flash_bwd_dq": lambda: kf.flash_dq_plain(q, k, v, do, lse,
                                                      delta, **kw),
            "flash_bwd_dkv": lambda: kf.flash_dkv_plain(q, k, v, do, lse,
                                                        delta, **kw)}
        t = {}
        with torch.no_grad():     # both figures of a kernel back to back
            for kname, fn in calls.items():
                t[kname] = (device_fn(torch, fn, reps=reps),
                            time_fn(torch, fn, reps=reps), clocks(dev),
                            time_fn(torch, plains[kname], reps=3))
            lib_f = device_fn(torch, lambda: sdpa(q, k, v, is_causal=causal),
                              reps=reps)
            lib_f_event = time_fn(torch, lambda: sdpa(q, k, v,
                                                      is_causal=causal),
                                  reps=reps)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]

        def sdpa_fwdbwd():
            return torch.autograd.grad(sdpa(*leaves, is_causal=causal),
                                       leaves, grad_outputs=do)

        lib_fb = device_fn(torch, sdpa_fwdbwd, reps=reps)
        lib_fb_event = time_fn(torch, sdpa_fwdbwd, reps=reps)
        lib = {"flash_fwd": (lib_f, lib_f_event),
               "flash_bwd_dq": (lib_fb - lib_f, lib_fb_event - lib_f_event),
               "flash_bwd_dkv": (lib_fb - lib_f, lib_fb_event - lib_f_event)}
        bounds = flash_bound(shape, dtype)
        res = {}
        for kname, (ms, event, clk, plain) in t.items():
            nbytes, ops = bounds[kname]
            bnd, by = bound_ms(nbytes, ops, PEAK_OPS[dtype])
            tf32 = ""
            if dtype == "float32":
                # the float32 route runs in 3xTF32: its bound is at that
                # rate, the CUDA-core bound printed beside it
                tf32 = f" (CUDA-core float32 bound {bnd:.5f} ms)"
                bnd, by = bound_ms(nbytes, ops, PEAK_3XTF32)
            res[kname] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                              bound_by=by, library_ms=lib[kname][0],
                              event_ms=event,
                              library_event_ms=lib[kname][1])
            say(f"time {kname} {name} B={B} H={H} S={S} D={D} {dtype}: "
                f"kernel {ms:.4f} ms device ({event:.4f} ms by events), "
                f"plain {plain:.4f} ms, bound {bnd:.5f} ms ({by}: {nbytes} "
                f"B, {ops} ops){tf32}, sdpa "
                f"{'forward' if kname == 'flash_fwd' else 'backward (pair)'}"
                f" {lib[kname][0]:.4f} ms device ({lib[kname][1]:.4f} ms by "
                f"events){clk}")
        if shape is shapes[0]:
            KV = kv_heads
            G = H // KV
            qg = q.permute(0, 2, 1, 3).reshape(B, S, KV, G, D).contiguous()
            kg, vg = (x[:, ::G].permute(0, 2, 1, 3).contiguous()
                      for x in (k, v))
            pos = torch.arange(S, device=dev)[None].expand(B, S)
            dog = do.permute(0, 2, 1, 3).reshape(B, S, KV, G, D)
            with torch.no_grad():
                m_f = time_fn(torch, lambda: _attend_masked(qg, kg, vg, pos,
                                                            pos), reps=5)
            gl = [x.detach().requires_grad_() for x in (qg, kg, vg)]
            m_fb = time_fn(torch, lambda: torch.autograd.grad(
                _attend_masked(*gl, pos, pos), gl, grad_outputs=dog), reps=5)
            fl = sum(res[n]["ms"] for n in res)
            say(f"time attention {name} B={B} S={S} {H} heads ({KV} KV) "
                f"D={D} {dtype}: plain _attend_masked forward {m_f:.4f} ms, "
                f"fwd+bwd {m_fb:.4f} ms (by events); flash kernels forward "
                f"{res['flash_fwd']['ms']:.4f} ms, fwd+bwd (3 kernels) "
                f"{fl:.4f} ms; sdpa forward {lib_f:.4f} ms, fwd+bwd "
                f"{lib_fb:.4f} ms (device)")
            res["flash_fwd"]["attend_masked_fwd_ms"] = m_f
            res["flash_fwd"]["attend_masked_fwdbwd_ms"] = m_fb
            del qg, kg, vg, gl, dog
        found[name] = (shape, res)
        del q, k, v, do, out, lse, delta, leaves
    at_shape, at = found[entry]
    _, B, H, S, D, (dtype, *_), causal, window = at_shape
    lib_what = {"flash_fwd": "sdpa forward",
                "flash_bwd_dq": "sdpa backward, for the dq/dkv pair",
                "flash_bwd_dkv": "none: sdpa's backward stands on "
                                 "flash_bwd_dq for the pair"}
    entries = []
    for kname, src, line in (("flash_fwd", "flash.cu", 69),
                             ("flash_bwd_dq", "flash_bwd.cu", 101),
                             ("flash_bwd_dkv", "flash_bwd.cu", 130)):
        counter = "flash_fwd" if kname == "flash_fwd" else "flash_bwd"
        n = launches[counter] // (1 if kname == "flash_fwd" else 2)
        other = "; ".join(
            f"{nm} (B={sh[1]} H={sh[2]} S={sh[3]} D={sh[4]} {sh[5][0]}): "
            f"kernel {r[kname]['ms']:.4f} ms, plain "
            f"{r[kname]['plain_ms']:.4f} ms, sdpa "
            f"{'forward' if kname == 'flash_fwd' else 'backward (pair)'} "
            f"{r[kname]['library_ms']:.4f} ms, bound "
            f"{r[kname]['bound_ms']:.5f} ms ({r[kname]['bound_by']})"
            for nm, (sh, r) in found.items() if nm != entry)
        e = {"name": kname, "route": "cuda",
             "source": f"src/repro_torch/csrc/{src}",
             "replaces": f"src/repro/kernels/flash.py:{line}",
             "launches": n, "max_abs_err": errs[entry][kname],
             "launches_by_path": {"bench": n},
             "per": f"launch at {entry}, B={B} H={H} S={S} D={D} {dtype} "
                    f"causal={causal} window={window} (library: "
                    f"{lib_what[kname]}); {other}"}
        e.update(at[kname])
        if kname == "flash_bwd_dkv":
            e["library_ms"] = e["library_event_ms"] = None
        entries.append(e)
    return entries


def run(torch, np, cfg, dev, *, kernel: str, time_fn, device_fn=None,
        train_shape=(2048, 4), encdec_shape=MNIST,
        encdec_steps=TWO_PHASE_STEPS, bfly_shapes=BFLY_SHAPES,
        flash_shapes=FLASH_SHAPES, flash_timed=FLASH_TIMED,
        bench=None, wide=WIDE, cli=CLI_SERVE) -> list:
    """Phases 3 to 19 on ``cfg`` and ``dev``; ``kernel`` is the backend
    held against the plain versions (``"cuda"`` on the card),
    ``train_shape`` the training run's (seq_len, global_batch),
    ``encdec_shape`` the encoder-decoder's (n, d, k), ``encdec_steps`` its
    two phases' steps, ``bfly_shapes`` the butterfly kernels' checks,
    ``flash_shapes`` the flash kernels' besides the training attention
    (``train_shape``, ``cfg``'s heads), ``flash_timed`` the names of those
    timed besides it (the first is the one the kernels line reports),
    ``bench`` the keyword arguments of ``launch.speed.run`` (none: the
    reference's sizes), ``wide`` the sandwich widths of
    :func:`phase_wide` and ``cli`` the serving tier's sizes of
    :func:`phase_serve_cli`.
    Prints a ``summary:`` line of the end-to-end readings and returns the
    ``kernels`` list."""
    device_fn = device_fn or time_fn
    train_rows = train_shape[0] * train_shape[1]
    errs = {"sandwich_fwd": max(phase_sandwich_factors(torch, cfg, dev,
                                                       kernel),
                                phase_sandwich(torch, cfg, dev, kernel,
                                               train_rows)),
            "paged_decode_attention": phase_paged(torch, cfg, dev, kernel),
            "sandwich_bwd": phase_sandwich_bwd(torch, cfg, dev, kernel,
                                               train_rows)}
    phase_wide(torch, dev, kernel, wide)
    errs.update(phase_butterfly(torch, dev, kernel, bfly_shapes))
    from repro_torch.launch import speed
    phase_sandwich_bwd_bench(torch, dev, kernel,
                             max((bench or {}).get("ns") or speed.BACKWARD_NS))
    train_attn = ("train", train_shape[1], cfg.n_heads, train_shape[0],
                  cfg.head_dim_, (cfg.compute_dtype,), True, 0)
    flash_shapes = (train_attn, *flash_shapes)
    flash_errs = phase_flash(torch, dev, kernel, flash_shapes)
    launches, summary, eager_tokens = phase_serve(torch, np, cfg, dev,
                                                  kernel)
    phase_serve_tokens(torch, np, dev)
    summary.update(phase_serve_incremental(torch, np, cfg, dev,
                                           eager_tokens))
    summary.update(phase_serve_spec(torch, np, cfg, dev, kernel,
                                    eager_tokens))
    router_launches, cli_summary = phase_serve_cli(torch, cfg, dev, cli)
    summary.update(cli_summary)
    kernels = phase_timing(torch, cfg, dev, kernel, time_fn, device_fn,
                           launches, errs, train_rows)
    paged = kernels[1]
    paged["launches_by_path"] = {
        "serve": paged["launches"],
        "router": router_launches["paged_decode_attention"]}
    paged["launches"] += router_launches["paged_decode_attention"]
    summary.update(phase_profile(torch, np, cfg, dev))
    train_launches, train_summary = phase_train(torch, np, cfg, dev,
                                                *train_shape)
    summary.update(train_summary)
    phase_train_gradcheck(torch, np, cfg, dev, kernel)
    phase_train_step_f32(torch, cfg, dev, kernel)
    kernels.append(phase_timing_bwd(
        torch, cfg, dev, kernel, time_fn, train_launches["sandwich_bwd"],
        errs["sandwich_bwd"], train_rows))
    fwd = kernels[0]
    fwd["launches_by_path"] = {"serve": fwd["launches"],
                               "router": router_launches["sandwich_fwd"],
                               "train": train_launches["sandwich_fwd"]}
    fwd["launches"] += (train_launches["sandwich_fwd"]
                        + router_launches["sandwich_fwd"])
    kernels[-1]["launches_by_path"] = {"train": kernels[-1]["launches"]}
    encdec_launches, encdec_summary, problem = phase_encdec(
        torch, dev, encdec_shape, encdec_steps)
    summary.update(encdec_summary)
    phase_encdec_vs_plain(torch, dev, kernel, *problem)
    del problem
    kernels += phase_timing_butterfly(torch, dev, kernel, time_fn, device_fn,
                                      encdec_launches, errs, encdec_shape,
                                      bfly_shapes)
    bench_launches = phase_bench(torch, dev, kernel, bench or {})
    phase_flash_autograd(torch, dev, kernel, flash_shapes[0])
    for k in kernels:
        n = bench_launches.get(k.get("counter", k["name"]), 0)
        if n:
            k["launches_by_path"]["bench"] = n
            k["launches"] += n
    kernels += phase_timing_flash(
        torch, dev, kernel, time_fn, device_fn, bench_launches, flash_errs,
        [train_attn] + [s for s in flash_shapes if s[0] in flash_timed],
        flash_timed[0], cfg.n_kv_heads)
    say("summary: " + json.dumps(summary))
    return kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; nothing was run\n")
        return 2
    if not (SRC / "repro_torch").is_dir():
        sys.stderr.write(f"chip_smoke: {SRC / 'repro_torch'} not found; run "
                         f"from a checkout of the repository\n")
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.configs import registry

    t_start = time.monotonic()
    smi = phase_device(torch)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    kernels = run(torch, np, registry.get("smollm-135m-butterfly"), dev,
                  kernel="cuda", time_fn=cuda_ms, device_fn=device_ms)
    say(f"total: {time.monotonic() - t_start:.1f} s")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

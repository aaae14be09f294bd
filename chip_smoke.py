#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU, end to end.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.

1. Device: the card's name, count and power limit.
2. Build: the three CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` each, in parallel), with their ``-Xptxas -v`` register,
   shared-memory and spill lines.
3. Sandwich forward kernel vs its plain twin at the three full-width sites
   of ``smollm-135m-butterfly`` (up/gate 576->1536, down 1536->576,
   lm_head 576->49152), at 8, 8x16 and the training run's 8192 rows,
   float32 at 2e-4 and bfloat16 at 5e-2.
4. Paged decode kernel vs its plain twin: 8 slots, 3 KV heads, 3 query
   heads per group, head dim 64, pages of 16, up to 512 positions, with a
   dirty trash page, stale rows and NaN pages past ``cur_pos``; float32 at
   1e-5 and bfloat16 at 2e-2.
5. Sandwich backward kernel vs its plain twin at the three sites, at 256
   rows and at the training run's 8192 (the head at 2048: the plain twin's
   memory), float32 at 1e-5 and bfloat16 at 8% of max|want|; two launches
   bit-identical.
6. Serving: a ServeEngine on full-width ``smollm-135m-butterfly``
   (random weights from seed 0, bfloat16 compute, 8 slots, max_len 512,
   prefill chunks of 16, greedy) serves 16 requests with prompts of 5 to
   200 tokens and 32 new tokens each. Checks: every request gets its 32
   tokens, the kernels' launch counters rose by 91 (sandwich) and 30
   (paged) per decode tick and 91 per chunk tick, no NaN appears in the
   logits or the KV pool, and a pooled decode tick on live engine state
   agrees with the plain versions layer by layer: each of the 30 layers
   and the head runs under both on the same input, within 5e-2 in
   relative norm. (The whole tick's logits through both paths are
   printed, not held: bf16 rounding differences grow through a
   random-init stack.)
7. Timing with CUDA events: each forward kernel, its plain twin, and for
   the paged kernel one library call (``scaled_dot_product_attention``
   over gathered KV) as a yardstick the port never calls; each kernel's
   bound from its bytes and operations (the sandwich's on the support it
   needs) over the H100's 3.35 TB/s and peak rates.
8. Profile: ``torch.profiler`` over three pooled decode ticks — device
   time by kernel and the device-busy share of the ticks' wall time.
9. Training: ``Trainer`` on full-width ``smollm-135m-butterfly`` (bf16
   compute, remat), seq_len 2048 x batch 4, 2 warm and 5 timed steps;
   finite losses, 181 forward and 3 x 91 backward sandwich launches per
   step; one more step under ``torch.profiler``.
10. Gradient checks of one step (seq_len 256, batch 1): each layer and the
    head under the kernels and the plain versions on the plain path's
    inputs and cotangents, every butterfly leaf within 5e-2 in relative
    norm; and the whole step in float32 compute, every butterfly leaf
    within 1e-3.
11. Timing of the backward kernel per train step, its plain twin and its
    bound.

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
SANDWICH_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
PAGED_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SLOTS, MAX_LEN, CHUNK, NEW_TOKENS, N_REQUESTS = 8, 512, 16, 32, 16


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
    # the plain float32 twins must stay float32: no TF32 in their matmuls
    # or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
            if any(k in line for k in ("registers", "spill", "smem")):
                say(f"ptxas[{name}]: {line.strip()}")


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


def phase_sandwich(torch, cfg, dev, kernel: str, train_rows: int) -> float:
    """The forward kernel against its plain twin at the three full-width
    sites: the decode and chunk ticks' rows and the training run's."""
    worst = 0.0
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for site in sites(cfg):
            spec, layer = sandwich_site(torch, cfg, site, dev)
            for rows in sorted({SLOTS, SLOTS * CHUNK, train_rows}):
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


def paged_inputs(torch, cfg, dtype, dev, seed=2):
    """q, pools, page table and cur_pos at the engine's decode shape, with
    a dirty trash page, stale rows and NaN pages past cur_pos."""
    from repro_torch.kernels import paged_attention as pa
    KV, D = cfg.n_kv_heads, cfg.head_dim_
    G = cfg.n_heads // KV
    ps, P = 16, MAX_LEN // 16
    gen = torch.Generator().manual_seed(seed)
    N = 1 + SLOTS * P
    k_pool = torch.randn(N, ps, KV, D, generator=gen)
    v_pool = torch.randn(N, ps, KV, D, generator=gen)
    ids = (torch.randperm(N - 1, generator=gen) + 1).reshape(SLOTS, P)
    cur = torch.tensor([0, 15, 16, 100, 255, 300, 511, 47])
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
    from repro_torch.kernels import paged_attention as pa
    worst = 0.0
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            args = paged_inputs(torch, cfg, getattr(torch, dtype), dev)
            got = pa.paged_decode_attention(*args, backend=kernel)
            want = pa.paged_decode_attention(*args, backend="torch")
            sync(torch, dev)
            err = allclose_or_raise(torch, f"paged {dtype}", got, want,
                                    PAGED_TOL[dtype])
            say(f"paged B={SLOTS} {tuple(args[0].shape)} ps=16 {dtype:9s} "
                f"max|err|={err:.3e} (tol {PAGED_TOL[dtype]})")
            if dtype == cfg.compute_dtype:
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
    cfg, model, tol = eng.cfg, eng.model, 5e-2
    tokens, cur_pos, active = eng.decode_inputs()
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


def phase_serve(torch, np, cfg, dev, kernel: str) -> tuple:
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    from repro_torch.serve import Request, ServeEngine

    t0 = time.monotonic()
    model = model_of(cfg, dev)
    say(f"init: {time.monotonic() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    rng = np.random.default_rng(0)
    lens = rng.permutation(np.linspace(5, 200, N_REQUESTS).astype(int))
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]
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
    del probe

    # the main path: counters from 0, 16 requests to completion
    eng = ServeEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN,
                      prefill_chunk=CHUNK, device=dev)
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ks.sandwich_forward.launches = 0
    pa.paged_decode_attention.launches = 0
    futs = [eng.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS))
            for p in prompts]
    t0 = time.monotonic()
    eng.run_until_idle()
    sync(torch, dev)
    wall = time.monotonic() - t0
    launches = {"sandwich_fwd": ks.sandwich_forward.launches,
                "paged_decode_attention": pa.paged_decode_attention.launches}
    snap = eng.metrics.snapshot()
    for i, f in enumerate(futs):
        toks = f.result(timeout=0).tokens
        if len(toks) != NEW_TOKENS:
            raise AssertionError(f"request {i}: {len(toks)} tokens, "
                                 f"expected {NEW_TOKENS}")
    on_card = dev.type == "cuda"       # on the CPU the plain versions run
    want = {"sandwich_fwd": on_card * per_tick * (snap["decode_steps"]
                                                  + snap["chunk_ticks"]),
            "paged_decode_attention": on_card * cfg.n_layers
            * snap["decode_steps"]}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    for name, pool in eng.caches.items():
        if not bool(torch.isfinite(pool).all()):
            raise AssertionError(f"non-finite values in the {name} pool")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    say(f"serve: {N_REQUESTS} requests, prompts {int(lens.min())}-"
        f"{int(lens.max())} tokens, {snap['ticks']} ticks "
        f"({snap['chunk_ticks']} chunk, {snap['decode_steps']} decode), "
        f"wall {wall:.3f} s")
    say(f"serve: TTFT p50 {snap['ttft_ms']['p50']} ms, p95 "
        f"{snap['ttft_ms']['p95']} ms; TPOT p50 {snap['tpot_ms']['p50']} ms; "
        f"decode {snap['decode_tok_per_s']:.1f} tok/s; peak memory "
        f"{peak / 2**20:.1f} MiB")
    say(f"serve: launches {launches} = {per_tick}/tick x (decode + chunk), "
        f"{cfg.n_layers}/decode tick")
    summary = {"ttft_p50_ms": snap["ttft_ms"]["p50"],
               "ttft_p95_ms": snap["ttft_ms"]["p95"],
               "tpot_p50_ms": snap["tpot_ms"]["p50"],
               "decode_tok_per_s": snap["decode_tok_per_s"],
               "peak_mib": peak / 2**20, "wall_s": wall,
               "ticks": snap["ticks"]}
    return launches, summary


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


def phase_timing(torch, cfg, dev, kernel, time_fn, launches, errs) -> list:
    from repro_torch.kernels import paged_attention as pa
    dt = cfg.compute_dtype
    gen = torch.Generator().manual_seed(3)
    mix = {"up_gate": 2 * cfg.n_layers, "down": cfg.n_layers, "lm_head": 1}
    tick = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0,
            "ops": 0}
    with torch.no_grad():
        for site, count in mix.items():
            spec, layer = sandwich_site(torch, cfg, site, dev)
            x = torch.randn(SLOTS, spec.n_in, generator=gen).to(
                dev, getattr(torch, dt))
            ms = time_fn(torch, lambda: sandwich_call(
                torch, spec, layer, x, kernel), reps=200)
            plain = time_fn(torch, lambda: sandwich_call(
                torch, spec, layer, x, "torch"), reps=20)
            nbytes, ops = sandwich_bound(spec, SLOTS, dt)
            bnd, _ = bound_ms(nbytes, ops, PEAK_OPS["float32"])
            say(f"time sandwich {site:8s} rows={SLOTS} {dt}: kernel "
                f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.5f} ms "
                f"({nbytes} B, {ops} ops); x{count} per decode tick")
            for key, val in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bnd)):
                tick[key] += count * val
            tick["bytes"] += count * nbytes
            tick["ops"] += count * ops
        _, by = bound_ms(tick["bytes"], tick["ops"], PEAK_OPS["float32"])
        say(f"time sandwich per decode tick ({sum(mix.values())} launches): "
            f"kernel {tick['ms']:.4f} ms, plain {tick['plain_ms']:.4f} ms, "
            f"bound {tick['bound_ms']:.5f} ms")

        q, k_pool, v_pool, ids, cur = paged_inputs(
            torch, cfg, getattr(torch, dt), dev)
        ms_p = time_fn(torch, lambda: pa.paged_decode_attention(
            q, k_pool, v_pool, ids, cur, backend=kernel), reps=500)
        plain_p = time_fn(torch, lambda: pa.paged_decode_attention(
            q, k_pool, v_pool, ids, cur, backend="torch"), reps=50)
        # yardstick: one SDPA call over KV gathered and head-expanded
        # beforehand (not timed); head = kv * G + g
        B, KV, G, D = q.shape
        L = ids.shape[1] * k_pool.shape[1]

        def heads(pool):
            kv = pa.gather_pages(pool, ids).permute(0, 2, 1, 3)
            return kv.repeat_interleave(G, dim=1).contiguous()

        kg, vg = heads(k_pool), heads(v_pool)
        mask = (torch.arange(L, device=dev)[None, :]
                <= cur[:, None].long())[:, None, None, :]
        qh = q.reshape(B, KV * G, 1, D)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = time_fn(torch, lambda: sdpa(qh, kg, vg, attn_mask=mask),
                         reps=500)
        live = int((cur.long() + 1).sum())
        itemsize = q.element_size()
        p_bytes = (2 * q.numel() * itemsize + 2 * live * KV * D * itemsize
                   + ids.numel() * 4 + cur.numel() * 4)
        p_ops = 4 * live * KV * G * D
        p_bound, p_by = bound_ms(p_bytes, p_ops, PEAK_OPS[dt])
        say(f"time paged B={B} live positions={live} {dt}: kernel "
            f"{ms_p:.4f} ms, plain {plain_p:.4f} ms, sdpa {lib_ms:.4f} ms, "
            f"bound {p_bound:.5f} ms ({p_bytes} B, {p_ops} ops); "
            f"x{cfg.n_layers} per decode tick")

    return [
        {"name": "sandwich_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/sandwich.cu",
         "replaces": "src/repro/kernels/sandwich.py:75",
         "launches": launches["sandwich_fwd"],
         "max_abs_err": errs["sandwich_fwd"],
         "ms": tick["ms"], "plain_ms": tick["plain_ms"],
         "bound_ms": tick["bound_ms"], "bound_by": by, "library_ms": None,
         "per": f"decode tick: {sum(mix.values())} launches at {SLOTS} rows"},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:92",
         "launches": launches["paged_decode_attention"],
         "max_abs_err": errs["paged_decode_attention"],
         "ms": ms_p, "plain_ms": plain_p, "bound_ms": p_bound,
         "bound_by": p_by, "library_ms": lib_ms,
         "per": f"launch: B={SLOTS}, {live} live positions"},
    ]


def phase_profile(torch, np, cfg, dev) -> dict:
    """Where a pooled decode tick's time goes: ``torch.profiler`` over
    three decode ticks of 8 slots (prompts of 5 tokens), device time by
    kernel and the device-busy share of the ticks' wall time. Returns the
    per-tick wall and busy ms and device launches ({} where the profiler
    saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, model_of(cfg, dev), slots=SLOTS, max_len=MAX_LEN,
                      prefill_chunk=CHUNK, device=dev)
    rng = np.random.default_rng(4)
    for _ in range(SLOTS):
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab_size, 5),
                           max_new_tokens=NEW_TOKENS))
    eng.step()                                  # prefill + first decode
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    ticks = 3
    with profile(activities=acts) as prof:
        sync(torch, dev)
        t0 = time.monotonic()
        for _ in range(ticks):
            eng.step()
        sync(torch, dev)
        wall_us = (time.monotonic() - t0) * 1e6
    # device-side events only (kernels, copies): the host ops that launch
    # them carry the same device time again
    events = [(e.key, e.self_device_time_total, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e[1] for e in events)
    if not busy_us:
        say("profile: device time not measured")
        return {}
    say(f"profile: {ticks} decode ticks, wall {wall_us / ticks / 1e3:.3f} "
        f"ms/tick, device busy {busy_us / ticks / 1e3:.3f} ms/tick "
        f"({100 * busy_us / wall_us:.1f}% of wall), "
        f"{sum(e[2] for e in events) // ticks} device launches/tick")
    for key, us, count in sorted(events, key=lambda e: -e[1])[:8]:
        say(f"profile: {us / ticks / 1e3:8.3f} ms/tick {count // ticks:5d} "
            f"launches/tick  {key[:90]}")
    return {"profile_wall_ms_per_tick": wall_us / ticks / 1e3,
            "profile_busy_ms_per_tick": busy_us / ticks / 1e3,
            "profile_launches_per_tick": sum(e[2] for e in events) // ticks}


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


def phase_sandwich_bwd(torch, cfg, dev, kernel: str, train_rows: int
                       ) -> float:
    """The backward kernel against its plain twin at the three full-width
    sites, float32 and bfloat16, at BWD_ROWS rows and at the training run's
    ``train_rows`` (the head at no more than HEAD_BWD_ROWS), where each
    block loops over many rows; two launches on the same inputs must give
    bit-identical gradients."""
    worst = 0.0
    gen = torch.Generator().manual_seed(11)
    names = ("dx", "d b_in", "d core", "d b_out")
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
            got = sandwich_bwd_call(torch, spec, layer, x, g, kernel)
            again = sandwich_bwd_call(torch, spec, layer, x, g, kernel)
            want = sandwich_bwd_call(torch, spec, layer, x, g, "torch")
            sync(torch, dev)
            errs = []
            for name, a, b, w in zip(names, got, again, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"sandwich_bwd {site} rows={rows} "
                                         f"{dtype} {name}: two launches "
                                         f"differ")
                errs.append(grad_close_or_raise(
                    torch, f"sandwich_bwd {site} rows={rows} {dtype} {name}",
                    a, w, dtype))
            say(f"sandwich_bwd {site:8s} rows={rows:4d} {dtype:9s} max|err| "
                "(share of max|want|) "
                + " ".join(f"{n.replace(' ', '')} {e:.3e} ({r:.1e})"
                           for n, (e, r) in zip(names, errs))
                + f"; tol {GRAD_TOL[dtype]} of max|want|; repeat "
                  f"bit-identical")
            if dtype == cfg.compute_dtype:
                worst = max(worst, *(e for e, _ in errs))
    return worst


def train_counts(cfg) -> tuple:
    """Sandwich forward and backward launches per train step: every site
    once forward and once backward (three kernels: output side, input side,
    reduction), and with remat the 90 MLP sites (the checkpointed layers)
    once more forward inside the backward pass."""
    from repro_torch.kernels import sandwich as ks
    sites_per_step = 3 * cfg.n_layers + 1
    return (sites_per_step + (3 * cfg.n_layers if cfg.remat else 0),
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
    bwd_us = sum(e[1] for e in events if "sandwich_bwd" in e[0])
    fwd_us = sum(e[1] for e in events if "sandwich_fwd" in e[0])
    say(f"profile train: one step, wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{sum(e[2] for e in events)} device launches; sandwich backward "
        f"kernels {bwd_us / 1e3:.3f} ms, forward {fwd_us / 1e3:.3f} ms")
    for key, us, count in sorted(events, key=lambda e: -e[1])[:10]:
        say(f"profile train: {us / 1e3:9.3f} ms {count:6d} launches  "
            f"{key[:90]}")
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
    """CUDA-event times of the backward: kernel, plain twin and bound over
    one train step's site mix at BWD_ROWS rows (the plain twin cannot take
    the head at the training run's rows), and the kernel and bound alone
    at the training run's ``train_rows``. ``launches`` counts kernels, three
    per call."""
    dt = cfg.compute_dtype
    gen = torch.Generator().manual_seed(13)
    mix = {"up_gate": 2 * cfg.n_layers, "down": cfg.n_layers, "lm_head": 1}
    step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0,
            "ops": 0, "full_ms": 0.0, "full_bound_ms": 0.0}
    with torch.no_grad():
        for site, count in mix.items():
            spec, layer = sandwich_site(torch, cfg, site, dev)

            def inputs(rows):
                return (torch.randn(rows, spec.n_in, generator=gen).to(
                    dev, getattr(torch, dt)),
                    torch.randn(rows, spec.n_out, generator=gen).to(
                    dev, getattr(torch, dt)))

            x, g = inputs(BWD_ROWS)
            ms = time_fn(torch, lambda: sandwich_bwd_call(
                torch, spec, layer, x, g, kernel), reps=20)
            plain = time_fn(torch, lambda: sandwich_bwd_call(
                torch, spec, layer, x, g, "torch"), reps=5)
            nbytes, ops = sandwich_bwd_bound(spec, BWD_ROWS, dt)
            bnd, by = bound_ms(nbytes, ops, PEAK_OPS["float32"])
            xf, gf = inputs(train_rows)
            full = time_fn(torch, lambda: sandwich_bwd_call(
                torch, spec, layer, xf, gf, kernel), reps=5)
            fbytes, fops = sandwich_bwd_bound(spec, train_rows, dt)
            fbnd, fby = bound_ms(fbytes, fops, PEAK_OPS["float32"])
            del xf, gf
            say(f"time sandwich_bwd {site:8s} {dt}: rows={BWD_ROWS} kernel "
                f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.5f} ms "
                f"({by}); rows={train_rows} kernel {full:.4f} ms, bound "
                f"{fbnd:.5f} ms ({fby}: {fbytes} B, {fops} ops); x{count} "
                f"per train step")
            for key, val in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bnd), ("full_ms", full),
                             ("full_bound_ms", fbnd)):
                step[key] += count * val
            step["bytes"] += count * nbytes
            step["ops"] += count * ops
    _, by = bound_ms(step["bytes"], step["ops"], PEAK_OPS["float32"])
    say(f"time sandwich_bwd per train step ({sum(mix.values())} calls): "
        f"rows={BWD_ROWS} kernel {step['ms']:.4f} ms, plain "
        f"{step['plain_ms']:.4f} ms, bound {step['bound_ms']:.5f} ms; "
        f"rows={train_rows} kernel {step['full_ms']:.4f} ms, bound "
        f"{step['full_bound_ms']:.5f} ms")
    return {"name": "sandwich_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/sandwich_bwd.cu",
            "replaces": "src/repro/kernels/sandwich.py:89",
            "launches": launches, "max_abs_err": err,
            "ms": step["ms"], "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"], "bound_by": by,
            "library_ms": None,
            "per": f"train step: {sum(mix.values())} calls of 3 launches at "
                   f"{BWD_ROWS} rows; at {train_rows} rows the "
                   f"kernel took {step['full_ms']:.4f} ms against a bound "
                   f"of {step['full_bound_ms']:.5f} ms"}


def run(torch, np, cfg, dev, *, kernel: str, time_fn,
        train_shape=(2048, 4)) -> list:
    """Phases 3 to 11 on ``cfg`` and ``dev``; ``kernel`` is the backend
    held against the plain versions (``"cuda"`` on the card),
    ``train_shape`` the training run's (seq_len, global_batch). Prints a
    ``summary:`` line of the end-to-end readings and returns the
    ``kernels`` list."""
    train_rows = train_shape[0] * train_shape[1]
    errs = {"sandwich_fwd": phase_sandwich(torch, cfg, dev, kernel,
                                           train_rows),
            "paged_decode_attention": phase_paged(torch, cfg, dev, kernel),
            "sandwich_bwd": phase_sandwich_bwd(torch, cfg, dev, kernel,
                                               train_rows)}
    launches, summary = phase_serve(torch, np, cfg, dev, kernel)
    kernels = phase_timing(torch, cfg, dev, kernel, time_fn, launches, errs)
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
                               "train": train_launches["sandwich_fwd"]}
    fwd["launches"] += train_launches["sandwich_fwd"]
    kernels[-1]["launches_by_path"] = {"train": kernels[-1]["launches"]}
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
                  kernel="cuda", time_fn=cuda_ms)
    say(f"total: {time.monotonic() - t_start:.1f} s")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

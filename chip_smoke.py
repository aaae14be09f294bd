#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU, end to end.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.

1. Device: the card's name, count and power limit.
2. Build: both CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   each, in parallel), with their ``-Xptxas -v`` register, shared-memory
   and spill lines.
3. Sandwich kernel vs its plain twin at the three full-width sites of
   ``smollm-135m-butterfly`` (up/gate 576->1536, down 1536->576, lm_head
   576->49152), 8 and 8x16 rows, float32 at 2e-4 and bfloat16 at 5e-2.
4. Paged decode kernel vs its plain twin: 8 slots, 3 KV heads, 3 query
   heads per group, head dim 64, pages of 16, up to 512 positions, with a
   dirty trash page, stale rows and NaN pages past ``cur_pos``; float32 at
   1e-5 and bfloat16 at 2e-2.
5. End to end: a ServeEngine on full-width ``smollm-135m-butterfly``
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
6. Timing with CUDA events: each kernel, its plain twin, and for the paged
   kernel one library call (``scaled_dot_product_attention`` over gathered
   KV) as a yardstick the port never calls; each kernel's bound from its
   bytes and operations over the H100's 3.35 TB/s and peak rates.
7. Profile: ``torch.profiler`` over three pooled decode ticks — device
   time by kernel and the device-busy share of the ticks' wall time.

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


def phase_sandwich(torch, cfg, dev, kernel: str) -> float:
    worst = 0.0
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for site in sites(cfg):
            spec, layer = sandwich_site(torch, cfg, site, dev)
            for rows in (SLOTS, SLOTS * CHUNK):
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


def sandwich_bound(spec, rows: int, dtype: str):
    """(bytes, ops) of one sandwich call: activations in and out once,
    float32 weights once; 3 ops per element per stage, 2 per core MAC."""
    itemsize = 2 if dtype == "bfloat16" else 4
    n1, n2 = spec.pad_in, spec.pad_out
    p1, p2 = int(math.log2(n1)), int(math.log2(n2))
    nbytes = (rows * (spec.n_in + spec.n_out) * itemsize
              + 4 * (2 * p1 * n1 + 2 * p2 * n2 + spec.k_in * spec.k_out
                     + spec.k_in + spec.k_out))
    ops = rows * (3 * (p1 * n1 + p2 * n2) + 2 * spec.k_in * spec.k_out)
    return nbytes, ops


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


def run(torch, np, cfg, dev, *, kernel: str, time_fn) -> list:
    """Phases 3 to 7 on ``cfg`` and ``dev``; ``kernel`` is the backend held
    against the plain versions (``"cuda"`` on the card). Prints a
    ``summary:`` line of the end-to-end readings and returns the
    ``kernels`` list."""
    errs = {"sandwich_fwd": phase_sandwich(torch, cfg, dev, kernel),
            "paged_decode_attention": phase_paged(torch, cfg, dev, kernel)}
    launches, summary = phase_serve(torch, np, cfg, dev, kernel)
    kernels = phase_timing(torch, cfg, dev, kernel, time_fn, launches, errs)
    summary.update(phase_profile(torch, np, cfg, dev))
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

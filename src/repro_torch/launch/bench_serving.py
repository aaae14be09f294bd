"""Serving bench: the twin of the reference's ``benchmarks/bench_serving.py``.

    python -m repro_torch.launch.bench_serving [--device cpu]
        [--requests N] [--max-new M] [--out FILE]

Replays the reference bench's seeded traces (:mod:`repro_torch.serve.trace`,
the same workloads byte for byte) through the port's greedy
:class:`~repro_torch.serve.ServeEngine` on the smoke arch (max_len 96,
pages and chunks of 16), after the same burn-in (one 8- and one 48-token
prompt build every graph key; then ``reset_metrics``), and prints the same
rows with the same ``derived`` fields, one ``name,us_per_call,derived``
line each after a header:

* ``serve/trace_e2e`` — skipped: it runs the dense pool, which is not
  ported (ROADMAP queue 1, item 5);
* ``serve/paged_e2e`` — wall µs to drain the bimodal trace (half the
  prompts span several prefill chunks) on 4 slots;
* ``serve/preempt_overload`` — the same trace on 8 usable pages under
  incremental admission: preemption and recompute;
* ``serve/spec_decode`` — ``spec_k=3`` on the butterfly smoke arch (the
  draft is the model's own butterfly head), held, as the reference holds
  it, to more than one committed token per slot tick;
* ``serve/router_slo`` — an open-loop Poisson trace at 100 req/s through
  the :class:`~repro_torch.serve.Router` over two replicas, one driver
  thread: TTFT and end-to-end latency p50/p95 and the dispatch split;
* ``serve/chrome_trace`` — untimed: the starved speculative trace through a
  one-replica router with a live :class:`~repro_torch.obs.Tracer`, the
  trace validated and written beside ``--out``;
* ``serve/large_pool`` — 16 slots and four times the requests: timed on
  the card, skipped on the CPU (as the reference skips it off its
  accelerator).

Rows follow :mod:`repro_torch.launch.speed` (``--out`` writes them as
JSON, by default ``build/bench_serving.json`` at the repo root, with the
device's name). The device defaults to the card.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch.speed import line, row, skipped

ARCH = "smollm-135m-smoke"
SPEC_ARCH = "smollm-135m-butterfly-smoke"
MAX_LEN = 96
BUILD = Path(__file__).resolve().parents[3] / "build"
DEFAULT_OUT = BUILD / "bench_serving.json"


def _items(cfg, requests, max_new, *, mix, chunk=16, seed=0, rate=0.0):
    """The reference bench's seeded workload."""
    from repro_torch.serve import trace as trace_lib
    spec = trace_lib.TraceSpec(requests=requests, seed=seed, rate=rate,
                               min_prompt=4, max_prompt=48, mix=mix,
                               chunk=chunk, max_new_tokens=max_new)
    return trace_lib.generate(spec, cfg.vocab_size)


def _drain(engine, prompts, max_new):
    from repro_torch.serve import Request
    futs = [engine.submit(Request(prompt=p, max_new_tokens=max_new))
            for p in prompts]
    engine.run_until_idle()
    for f in futs:
        f.result(0)


def _model(cfg, dev):
    from repro_torch.serve import loader
    return loader.init_params(cfg, seed=0, device=dev)


def _warm(engine, cfg, rng) -> None:
    """The burn-in: one multi-chunk prompt builds every key the trace
    takes; then the metrics (tick clock, trace ring) reset."""
    _drain(engine, [rng.integers(0, cfg.vocab_size, size=n)
                    for n in (8, 48)], 2)
    engine.reset_metrics()


def _run_engine(dev, slots: int, requests: int, max_new: int, seed: int = 0,
                admission: str = "eager", num_pages=None, arch: str = ARCH,
                spec_k: int = 0):
    from repro_torch.configs import registry
    from repro_torch.serve import ServeEngine

    cfg = registry.get(arch)
    engine = ServeEngine(cfg, _model(cfg, dev), slots=slots, max_len=MAX_LEN,
                         admission=admission, num_pages=num_pages,
                         spec_k=spec_k, seed=seed, device=dev)
    _warm(engine, cfg, np.random.default_rng(seed))
    warm = engine.compile_stats["compiles"]
    items = _items(cfg, requests, max_new, mix="bimodal",
                   chunk=engine.prefill_chunk, seed=seed)
    t0 = time.perf_counter()
    _drain(engine, [it.prompt for it in items], max_new)
    wall = time.perf_counter() - t0
    if engine.compile_stats["compiles"] != warm:
        raise RuntimeError("bench trace built a graph key; widen the "
                           "burn-in")
    return engine.metrics.snapshot(), wall


def _run_router(dev, replicas: int, requests: int, max_new: int,
                rate: float, seed: int = 0, slots: int = 2,
                arch: str = ARCH, admission: str = "eager", num_pages=None,
                spec_k: int = 0, tracer=None):
    """Open-loop run: a seeded Poisson trace at ``rate`` req/s through the
    Router over ``replicas`` warmed engines (each its own copy of the
    weights), one driver thread. Returns the router snapshot, the shed
    count and the wall seconds from the first arrival to the last
    result."""
    from repro_torch.configs import registry
    from repro_torch.serve import Router, ServeEngine
    from repro_torch.serve import trace as trace_lib

    cfg = registry.get(arch)
    model = _model(cfg, dev)
    rng = np.random.default_rng(seed)
    engines = []
    for i in range(replicas):
        e = ServeEngine(cfg, copy.deepcopy(model), slots=slots,
                        max_len=MAX_LEN, admission=admission,
                        num_pages=num_pages, spec_k=spec_k, tracer=tracer,
                        replica=i, seed=seed, device=dev)
        _warm(e, cfg, rng)
        engines.append(e)
    warm = [e.compile_stats["compiles"] for e in engines]
    items = _items(cfg, requests, max_new, mix="bimodal",
                   chunk=engines[0].prefill_chunk, seed=seed, rate=rate)
    with Router(engines) as router:
        t0 = time.perf_counter()
        futs, shed = trace_lib.replay(router.submit, items)
        for f in futs:
            f.result(timeout=600)
        wall = time.perf_counter() - t0
    if [e.compile_stats["compiles"] for e in engines] != warm:
        raise RuntimeError("router trace built a graph key; widen the "
                           "burn-in")
    return router.snapshot(), shed, wall


def _engine_derived(snap) -> str:
    tok_s = snap["decode_tok_per_s"]
    return f"us_per_tok={1e6 / tok_s:.1f};tok_s={tok_s:.1f};"


def run(dev: torch.device, requests: int = 24, max_new: int = 8,
        trace_path: Optional[Path] = None) -> List[Dict]:
    """Every row, in the reference bench's order."""
    from repro_torch.obs import Tracer
    from repro_torch.obs.validate import validate_chrome_trace

    rows = [skipped("serve/trace_e2e", "dense_pool_not_ported")]

    snap, wall = _run_engine(dev, 4, requests, max_new)
    rows.append(row(
        "serve/paged_e2e", wall * 1e6, _engine_derived(snap)
        + f"p50_ttft_ms={snap['ttft_ms']['p50']};"
        f"p95_ttft_ms={snap['ttft_ms']['p95']};"
        f"chunk_ticks={snap['chunk_ticks']};"
        f"pages_hwm={snap['pool']['pages_hwm']};"
        f"pages_total={snap['pool']['total_pages']};"
        f"requests={snap['requests_finished']};"
        f"tokens={snap['total_tokens']}", 1))

    # 8 usable 16-token pages across 4 slots cannot hold every admitted
    # request's budget: incremental admission grows, preempts, recomputes
    snap, wall = _run_engine(dev, 4, requests, max_new,
                             admission="incremental", num_pages=9)
    rows.append(row(
        "serve/preempt_overload", wall * 1e6, _engine_derived(snap)
        + f"preempted={snap['preempted']};"
        f"recompute_tokens={snap['recompute_tokens']};"
        f"exhausted={snap['pool']['exhausted_events']};"
        f"max_concurrent={snap['max_concurrent_slots']};"
        f"pages_hwm={snap['pool']['pages_hwm']};"
        f"p95_ttft_ms={snap['ttft_ms']['p95']};"
        f"requests={snap['requests_finished']};"
        f"tokens={snap['total_tokens']}", 1))

    snap, wall = _run_engine(dev, 4, requests, max_new, spec_k=3,
                             arch=SPEC_ARCH)
    sp = snap["spec"]
    if not sp["tokens_per_slot_tick"] > 1.0:
        raise RuntimeError(f"speculative decode must beat 1 token a slot "
                           f"tick, got {sp['tokens_per_slot_tick']}")
    rows.append(row(
        "serve/spec_decode", wall * 1e6, _engine_derived(snap)
        + f"tokens_per_slot_tick={sp['tokens_per_slot_tick']};"
        f"acceptance_rate={sp['acceptance_rate']};"
        f"spec_k={sp['k']};spec_ticks={sp['ticks']};"
        f"draft_tokens={sp['draft_tokens']};"
        f"accepted_draft_tokens={sp['accepted_draft_tokens']};"
        f"requests={snap['requests_finished']};"
        f"tokens={snap['total_tokens']}", 1))

    rsnap, shed, wall = _run_router(dev, 2, requests, max_new, rate=100.0)
    rows.append(row(
        "serve/router_slo", wall * 1e6,
        f"p50_ttft_ms={rsnap['ttft_ms']['p50']};"
        f"p95_ttft_ms={rsnap['ttft_ms']['p95']};"
        f"p50_latency_ms={rsnap['latency_ms']['p50']};"
        f"p95_latency_ms={rsnap['latency_ms']['p95']};"
        f"replicas={rsnap['replicas']};"
        "dispatched="
        + "/".join(str(p["dispatched"]) for p in rsnap["per_replica"])
        + f";max_concurrent={rsnap['max_concurrent_slots']};"
        f"shed={shed};requeued={rsnap['requeued']};"
        f"requests={rsnap['requests_finished']}", 1))

    tracer = Tracer()
    rsnap, _, _ = _run_router(dev, 1, requests, max_new, rate=0.0, slots=4,
                              arch=SPEC_ARCH, admission="incremental",
                              num_pages=9, spec_k=3, tracer=tracer)
    events = validate_chrome_trace(tracer.chrome_trace())
    esnap = rsnap["per_replica"][0]["engine"]
    if not esnap["preempted"]:
        raise RuntimeError("the trace artifact must cover a preemption")
    if not esnap["spec"]["draft_tokens"]:
        raise RuntimeError("the trace artifact must cover speculation")
    trace_path = Path(trace_path or BUILD / "serve_trace.json")
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    tracer.write_chrome_trace(str(trace_path))
    names = {e["name"] for e in events}
    rows.append({
        "name": "serve/chrome_trace", "us_per_call": None, "skipped": True,
        "calls": 0, "derived":
        f"status=artifact;path={trace_path};events={len(events)};"
        f"spans={sum(1 for e in events if e['ph'] == 'X')};"
        f"preempt_events={sum(1 for e in events if e['name'] == 'preempt')};"
        f"spec_spans={sum(1 for e in events if e['name'] == 'spec')};"
        f"has_grow_pages={'grow_pages' in names};"
        f"dropped={tracer.dropped};"
        f"requests={esnap['requests_finished']}"})

    if dev.type == "cuda":
        snap, wall = _run_engine(dev, 16, 4 * requests, max_new)
        tok_s = snap["decode_tok_per_s"]
        rows.append(row("serve/large_pool", 1e6 / tok_s if tok_s else None,
                        f"tok_s={tok_s:.1f};"
                        f"p95_ttft_ms={snap['ttft_ms']['p95']};"
                        f"occupancy={snap['slot_occupancy']}", 1))
    else:
        rows.append(skipped("serve/large_pool",
                            "16-slot pool too slow on CPU; timed on the "
                            "card"))
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.kernels.context import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="write the rows here as JSON (the Chrome trace "
                         "goes beside it as serve_trace.json)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = Path(args.out)
    sys.stdout.write("name,us_per_call,derived\n")
    rows = run(dev, args.requests, args.max_new,
               trace_path=out.parent / "serve_trace.json")
    for r in rows:
        sys.stdout.write(line(r) + "\n")
    out.parent.mkdir(parents=True, exist_ok=True)
    device = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu")
    with open(out, "w") as f:
        json.dump({"device": device, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Continuous-batching serving demo on :class:`repro_torch.serve.ServeEngine`.

Mixed-length prompts arrive over time through the async client; the engine
admits them into its decode slots as slots free up, prefilling in chunks
into a paged KV cache (whole prompts at their exact lengths for archs with
sliding-window rings, such as gemma3-27b), and advances every in-flight
request one token per pooled decode tick (on the card, ticks replay CUDA
graphs). Per-request TTFT/TPOT and the engine's throughput, occupancy and
pages are printed.

A second act shows the lifecycle on a deliberately tiny page pool: a
request *preempted* mid-decode under ``admission="incremental"`` (pages
freed, request requeued, prefix recomputed; archs that cannot chunk their
prefill wait for pages under eager admission instead) and a request
*cancelled*
through ``client.cancel(rid)``, recorded by a live tracer. A third act
runs two replicas behind the :class:`repro_torch.serve.Router` with a live
checkpoint hot-swap on a drained replica (the newest checkpoint on disk is
torn, so the loader falls back to the newest valid one) while the other
replica serves.

A frontend arch's requests carry their stub inputs
(:func:`repro_torch.serve.trace.stub_extras`:
internvl2-1b's ``frontend_embeds``, seamless-m4t-medium's ``frames``),
drawn as the reference's demo draws them.

Run: ``python -m repro_torch.examples.serve_lm --arch smollm-135m-smoke
[--device cpu]``; every registry arch is taken.
"""

from __future__ import annotations

import argparse
import copy
import tempfile
import time
from typing import List, Optional

import numpy as np

from repro_torch import convert
from repro_torch.kernels.context import resolve_device
from repro_torch.launch import ported_config
from repro_torch.serve.trace import stub_extras


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m-smoke")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--gen-len", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.serve import (Request, SamplingParams, ServeClient,
                                   ServeEngine, loader)

    cfg = ported_config(args.arch)
    dev = resolve_device(args.device)
    _, model = loader.load_for_serving(cfg, seed=0, device=dev)
    engine = ServeEngine(
        cfg, model, slots=args.slots, max_len=args.max_len,
        sampling=SamplingParams(temperature=args.temperature,
                                top_p=args.top_p), seed=0, device=dev)

    rng = np.random.default_rng(0)
    hi = min(48, args.max_len - args.gen_len)
    if hi < 4:
        raise SystemExit(
            f"--max-len {args.max_len} leaves no room for --gen-len "
            f"{args.gen_len}: need max_len - gen_len >= 4 (the per-slot "
            f"budget is prompt + generated tokens)")
    lengths = rng.integers(4, hi + 1, size=args.requests)
    print(f"arch={cfg.name}  slots={args.slots}  requests={args.requests}  "
          f"prompt lengths={lengths.tolist()}")

    futs = []
    with ServeClient(engine) as client:
        for plen in lengths:
            prompt = rng.integers(0, cfg.vocab_size, size=int(plen))
            futs.append(client.submit(Request(
                prompt=prompt, max_new_tokens=args.gen_len,
                extras=stub_extras(cfg, rng))))
            time.sleep(0.01)          # requests trickle in, engine runs
        for fut in futs:
            r = fut.result(timeout=600)
            m = r.metrics
            print(f"  req[{r.rid}] prompt={m.prompt_len:2d} "
                  f"ttft={m.ttft * 1e3:6.1f} ms  "
                  f"tpot={m.tpot * 1e3:5.1f} ms/token  "
                  f"tokens={r.tokens[:8]}{'...' if len(r.tokens) > 8 else ''}")

    snap = engine.metrics.snapshot()
    stats = engine.compile_stats
    print(f"decode: {snap['decode_tok_per_s']:.1f} tok/s  "
          f"occupancy: {snap['slot_occupancy']:.2f}  "
          f"ticks: {snap['ticks']}  pool: {snap['pool']['kind']} "
          f"(pages hwm {snap['pool']['pages_hwm']}/"
          f"{snap['pool']['total_pages']})  graphs built: "
          f"{stats['compiles']} ("
          + ("chunked prefill: one key for every prompt length)"
             if engine.prefill_chunk else
             "whole-prompt prefill runs eagerly, decode on one key)"))

    lifecycle_demo(cfg, model, rng, dev)
    router_demo(cfg, model, dev)
    return 0


def lifecycle_demo(cfg, model, rng, dev):
    """Preemption and cancellation on a page-starved engine, recorded by a
    live :class:`repro_torch.obs.Tracer` (``tracer.write_chrome_trace``
    exports it for Perfetto; the serving CLI's ``--trace-out`` does the
    same)."""
    from repro_torch.obs import Tracer
    from repro_torch.serve import (Request, RequestCancelled, ServeClient,
                                   ServeEngine)
    from repro_torch.serve.cache import chunked_prefill_supported

    # preemption recomputes through chunked prefill: archs without it wait
    # for pages under eager admission
    admission = ("incremental" if chunked_prefill_supported(cfg)
                 else "eager")
    print(f"\n-- lifecycle demo: tiny pool, {admission} admission --")
    tracer = Tracer()
    # 2 slots but only 4 usable 8-token pages: both requests' full budgets
    # cannot co-reside, so incremental admission must preempt
    engine = ServeEngine(cfg, model, slots=2, max_len=32, page_size=8,
                         num_pages=5, prefill_chunk=4, admission=admission,
                         tracer=tracer, seed=0, device=dev)
    with ServeClient(engine) as client:
        def mk():
            return rng.integers(0, cfg.vocab_size, size=5)

        def req(**kw):
            return Request(prompt=mk(), max_new_tokens=14,
                           extras=stub_extras(cfg, rng), **kw)

        f1 = client.submit(req())
        f2 = client.submit(req())
        f3 = client.submit(req(rid=99))
        client.cancel(99)
        for fut in (f1, f2):
            r = fut.result(timeout=600)
            tag = (f"preempted x{r.metrics.preemptions}, prefix recomputed"
                   if r.metrics.preemptions else "never preempted")
            print(f"  req[{r.rid}] finished with {len(r.tokens)} tokens "
                  f"({tag})")
        try:
            f3.result(timeout=600)
            print("  req[99] finished before the cancel landed")
        except RequestCancelled as e:
            print(f"  req[99] cancelled: {e}")
    snap = engine.metrics.snapshot()
    print(f"  engine counters: preempted={snap['preempted']} "
          f"recompute_tokens={snap['recompute_tokens']} "
          f"cancelled={snap['cancelled']}")
    counts = {}
    for ev in tracer.events():
        counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    print(f"  tracer recorded {len(tracer)} events: "
          f"preempt={counts.get('preempt', 0)} "
          f"cancel={counts.get('cancel', 0)} "
          f"finish={counts.get('finish', 0)} "
          f"ticks={counts.get('tick', 0)} "
          f"(tracer.write_chrome_trace(path) -> Perfetto)")


def router_demo(cfg, model, dev):
    """Two replicas behind the Router: balanced dispatch, then a live
    checkpoint hot-swap (drain replica 0, restore the newest valid
    checkpoint, swap the weights in, undrain) while replica 1 serves. Each
    replica holds its own copy of the weights: a swap copies in place."""
    from repro_torch.checkpoint.checkpointing import CheckpointManager
    from repro_torch.serve import Request, Router, ServeEngine
    from repro_torch.serve import trace as trace_lib
    from repro_torch.serve.faults import tear_checkpoint

    print("\n-- router demo: 2 replicas, drain + checkpoint hot-swap --")
    engines = [ServeEngine(cfg, copy.deepcopy(model), slots=2, max_len=32,
                           page_size=8, prefill_chunk=4, seed=0, device=dev,
                           replica=i) for i in range(2)]
    items = trace_lib.generate(
        trace_lib.TraceSpec(requests=6, seed=7, min_prompt=4,
                            max_prompt=12, max_new_tokens=8),
        cfg.vocab_size)
    router = Router(engines)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        tree = {"params": convert.to_jax_params(
            dict(model.named_parameters()), cfg)}
        mgr.save(1, tree)
        mgr.save(2, tree)
        tear_checkpoint(ckpt_dir)      # the newest step is now damaged
        with router:
            xrng = np.random.default_rng([7, 2])
            futs = [router.submit(it.request(extras=stub_extras(cfg, xrng)))
                    for it in items]
            step = router.swap_checkpoint(0, ckpt_dir)
            for fut in futs:
                fut.result(timeout=600)
    snap = router.snapshot()
    print(f"  swapped replica 0 to checkpoint step {step} (newest was "
          f"torn) while replica 1 served")
    print(f"  dispatched={[p['dispatched'] for p in snap['per_replica']]} "
          f"requeued={snap['requeued']} finished="
          f"{snap['requests_finished']} ttft p50="
          f"{snap['ttft_ms']['p50']:.1f} ms")


if __name__ == "__main__":
    raise SystemExit(main())

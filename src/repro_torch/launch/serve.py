"""Serving entry point: replay a synthetic request trace through the port.

    python -m repro_torch.launch.serve --arch smollm-135m-smoke \\
        --requests 16 --slots 4 --max-new 16 --rate 20 [--device cpu]

The port's twin of ``repro.launch.serve``, with its flags and its printed
``[serve]`` lines. It generates a seeded open-loop workload via
:mod:`repro_torch.serve.trace` (Poisson arrivals at ``--rate`` req/s,
``--mix`` prompt lengths — the trace the reference replays for the same
seed, byte for byte), submits it through the async
:class:`~repro_torch.serve.client.ServeClient` — or, with ``--replicas
N``, through the multi-replica :class:`~repro_torch.serve.router.Router`
— and prints per-request TTFT/TPOT plus the metrics summary (per engine,
or the router's aggregate with per-replica detail). ``--checkpoint-dir``
restores the newest valid checkpoint (fresh init otherwise); every
replica holds its own copy of the weights.

``--device`` picks the device: the card by default (raising without one),
``cpu`` for the plain PyTorch path. On the card the kernel libraries the
serving path launches are built before the driver thread starts, so a
first-use ``nvcc`` does not count against a tick.

Robustness knobs: ``--admission incremental`` switches to prompt-only
page reservation with preempt-youngest/recompute; ``--queue-limit N``
sheds submits beyond N waiting with ``QueueFull``; ``--fault-seed S`` arms
a seeded ``FaultInjector`` per replica forcing ``PoolExhausted`` at
``--fault-rate`` per allocation.

Observability: ``--trace-out trace.json`` records per-request span
timelines through one shared :class:`repro_torch.obs.Tracer` (replica
``i`` is ``pid i``) and exports Chrome trace-event JSON;
``--metrics-json`` writes the ``repro.serve/telemetry-1`` document
(summary + metrics-registry snapshot), rewritten atomically every
``--metrics-interval`` seconds while serving.

Not ported yet, and refused with a message rather than ignored:
``--pool dense`` and ``--prefill-chunk 0`` (whole-bucket admission;
ROADMAP queue 1, item 5), ``--mesh-shape`` and ``--simulated-devices``
(multi-device serving; item 6).

:func:`main` takes ``argv`` and returns the document ``--metrics-json``
writes, so it can be called in-process.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import threading
from typing import Dict, List, Optional

#: the CUDA libraries a served tick launches (the sandwich forward, the
#: paged decode), built before the driver starts
SERVE_LIBRARIES = ("sandwich", "paged_attention")


def _write_json_atomic(path: str, doc) -> None:
    """Write-then-rename so a reader polling the path never sees a torn
    doc (the periodic flusher rewrites it mid-run)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--arch", default="smollm-135m-smoke")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without a "
                         "card; 'cpu' serves through the plain versions)")
    ap.add_argument("--requests", type=int, default=16,
                    help="number of synthetic requests to replay")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve over N in-process engine replicas behind "
                         "the Router (weighted least-outstanding dispatch,"
                         " QueueFull failover); 1 = plain ServeClient")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128,
                    help="per-slot budget: prompt + generated tokens")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--pool", default="paged", choices=("paged", "dense"),
                    help="cache pool kind (only paged is ported)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged pool: tokens per page")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="paged pool: physical pages incl. the trash page "
                         "(0 = dense-equivalent capacity)")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="chunked-prefill chunk size (0, whole-bucket "
                         "admission, is not ported)")
    ap.add_argument("--admission", default="eager",
                    choices=("eager", "incremental"),
                    help="page reservation policy: eager = whole-budget at "
                         "admission (no preemption); incremental = prompt-"
                         "only + per-tick growth with preempt-youngest/"
                         "recompute on exhaustion")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft tokens proposed per "
                         "slot per tick through the model's own output "
                         "head, verified in one batched pass (0 = off; "
                         "greedy only)")
    ap.add_argument("--queue-limit", type=int, default=0,
                    help="bounded admission queue: submits beyond this "
                         "many waiting requests are shed with QueueFull "
                         "(0 = unbounded)")
    ap.add_argument("--fault-seed", type=int, default=-1,
                    help="arm a FaultInjector with this seed: forced "
                         "PoolExhausted at pool.alloc on a Bernoulli "
                         "schedule (-1 = no injection)")
    ap.add_argument("--fault-rate", type=float, default=0.05,
                    help="per-call fire probability for --fault-seed")
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=48)
    ap.add_argument("--mix", default="uniform",
                    choices=("uniform", "bimodal"),
                    help="prompt-length mix (see repro_torch.serve.trace): "
                         "uniform over [min,max], or bimodal short/long "
                         "around the prefill chunk")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="mean arrival rate (req/s); 0 = submit all "
                         "up front")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-json", default="",
                    help="write the telemetry doc here "
                         "(repro.serve/telemetry-1: summary + "
                         "metrics-registry snapshot)")
    ap.add_argument("--metrics-interval", type=float, default=0.0,
                    help="with --metrics-json: atomically rewrite the "
                         "telemetry doc every S seconds while serving "
                         "(0 = final write only)")
    ap.add_argument("--trace-out", default="",
                    help="record per-request span timelines and write a "
                         "Chrome trace-event JSON here; tracing stays off "
                         "without this flag")
    ap.add_argument("--mesh-shape", default="",
                    help="multi-device serving (not ported)")
    ap.add_argument("--simulated-devices", type=int, default=0,
                    help="simulated host devices (not ported)")
    return ap


def _refuse_unported(args) -> None:
    if args.pool == "dense":
        raise SystemExit("--pool dense is not ported: the port serves "
                         "through the paged pool only (ROADMAP queue 1, "
                         "item 5, brings the dense pool)")
    if args.prefill_chunk <= 0:
        raise SystemExit("--prefill-chunk 0 (whole-bucket admission) is not "
                         "ported: the port admits through chunked prefill "
                         "only (ROADMAP queue 1, item 5)")
    if args.mesh_shape or args.simulated_devices:
        raise SystemExit("--mesh-shape and --simulated-devices are not "
                         "ported: the port serves on one device (ROADMAP "
                         "queue 1, item 6, brings multi-device serving)")


def main(argv: Optional[List[str]] = None) -> Dict:
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    if args.replicas < 1:
        raise SystemExit(f"--replicas must be >= 1, got {args.replicas}")

    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.kernels.context import resolve_device
    from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer
    from repro_torch.serve import (FaultInjector, Router, SamplingParams,
                                   ServeClient, ServeEngine, loader, trace)

    cfg = registry.get(args.arch)
    dev = resolve_device(args.device)
    step, model = loader.load_for_serving(cfg, args.checkpoint_dir,
                                          seed=args.seed, device=dev)
    src = f"checkpoint step {step}" if step is not None else "fresh init"
    models = [model] + [copy.deepcopy(model)
                        for _ in range(args.replicas - 1)]
    # each replica gets its OWN injector (same seed => same per-replica
    # schedule) so one replica's allocations don't advance another's dice
    injectors = [FaultInjector(seed=args.fault_seed,
                               rates={"pool.alloc": args.fault_rate})
                 if args.fault_seed >= 0 else None
                 for _ in range(args.replicas)]
    # one registry and (with --trace-out) one tracer span every replica:
    # replica i is pid i in the Chrome trace, and the registry keeps the
    # per-replica families apart via the {"replica": i} label
    obs_registry = MetricsRegistry()
    tracer = Tracer() if args.trace_out else NULL_TRACER
    engines = [ServeEngine(
        cfg, m, slots=args.slots, max_len=args.max_len,
        page_size=args.page_size, num_pages=args.num_pages or None,
        prefill_chunk=args.prefill_chunk,
        sampling=SamplingParams(temperature=args.temperature,
                                top_k=args.top_k, top_p=args.top_p),
        admission=args.admission, spec_k=args.spec_k,
        queue_limit=args.queue_limit or None, faults=faults,
        seed=args.seed, device=dev, tracer=tracer, registry=obs_registry,
        replica=i)
        for i, (m, faults) in enumerate(zip(models, injectors))]
    engine, faults = engines[0], injectors[0]
    if dev.type == "cuda":
        build.build(SERVE_LIBRARIES)
    print(f"[serve] {cfg.name} | params: {src} | slots={args.slots} "
          f"max_len={args.max_len} pool=paged "
          f"chunk={engine.prefill_chunk} admission={engine.admission} "
          f"spec_k={engine.spec_k} "
          f"sampling=(T={args.temperature}, "
          f"k={args.top_k}, p={args.top_p}) | device={dev.type}"
          + (f" | replicas={args.replicas}" if args.replicas > 1 else ""))

    hi = min(args.max_prompt, args.max_len - args.max_new)
    if hi < args.min_prompt:
        raise SystemExit(
            f"no valid prompt length: min-prompt {args.min_prompt} > "
            f"min(max-prompt {args.max_prompt}, max-len {args.max_len} - "
            f"max-new {args.max_new}) = {hi}; raise --max-len or lower "
            f"--max-new/--min-prompt")
    try:
        spec = trace.TraceSpec(
            requests=args.requests, seed=args.seed, rate=args.rate,
            min_prompt=args.min_prompt, max_prompt=hi, mix=args.mix,
            chunk=engine.prefill_chunk, max_new_tokens=args.max_new)
    except ValueError as e:
        raise SystemExit(f"invalid trace: {e}")
    items = trace.generate(spec, cfg.vocab_size)

    def show(fut):
        r = fut.result(timeout=600)
        m = r.metrics
        pre = f" preempt={m.preemptions}" if m.preemptions else ""
        print(f"  req[{r.rid:03d}] prompt={m.prompt_len:3d} "
              f"new={m.new_tokens:3d} ttft={m.ttft * 1e3:7.1f} ms "
              f"tpot={m.tpot * 1e3:6.1f} ms "
              f"latency={m.latency * 1e3:7.1f} ms{pre}")

    stop_flush = threading.Event()

    def start_flusher(doc_fn):
        # periodic telemetry flush: atomically rewrite --metrics-json
        # every --metrics-interval seconds while the workload drains
        if not (args.metrics_json and args.metrics_interval > 0):
            return None

        def loop():
            while not stop_flush.wait(args.metrics_interval):
                _write_json_atomic(args.metrics_json, doc_fn())
        t = threading.Thread(target=loop, daemon=True,
                             name="metrics-flush")
        t.start()
        return t

    if args.replicas == 1:
        with ServeClient(engine) as client:
            flusher = start_flusher(engine.telemetry)
            try:
                futs, shed = trace.replay(client.submit, items)
                for fut in futs:
                    show(fut)
            finally:
                stop_flush.set()
                if flusher is not None:
                    flusher.join(timeout=10)
        out = snap = engine.metrics.snapshot()
        print(f"[serve] {snap['requests_finished']} requests, "
              f"{snap['total_tokens']} tokens | decode "
              f"{snap['decode_tok_per_s']:.1f} tok/s | occupancy "
              f"{snap['slot_occupancy']:.2f} | ttft p50/p95 "
              f"{snap['ttft_ms']['p50']:.1f}/{snap['ttft_ms']['p95']:.1f} "
              f"ms | pool={snap['pool']['kind']} pages_hwm="
              f"{snap['pool']['pages_hwm']}/{snap['pool']['total_pages']} "
              f"| compiles={engine.compile_stats['compiles']}")
        if snap["spec"]["k"]:
            sp = snap["spec"]
            print(f"[serve] speculative: k={sp['k']} "
                  f"acceptance={sp['acceptance_rate']:.3f} "
                  f"({sp['accepted_draft_tokens']}/{sp['draft_tokens']} "
                  f"drafts) "
                  f"tokens/slot-tick={sp['tokens_per_slot_tick']:.3f}")
        if (shed or snap["preempted"] or snap["cancelled"]
                or snap["deadline_expired"] or faults is not None):
            inj = (f" | faults={faults.summary()}" if faults is not None
                   else "")
            print(f"[serve] lifecycle: preempted={snap['preempted']} "
                  f"(recompute={snap['recompute_tokens']} tok) "
                  f"shed={shed} cancelled={snap['cancelled']} "
                  f"deadline_expired={snap['deadline_expired']}{inj}")
    else:
        router = Router(engines)
        with router:
            flusher = start_flusher(router.telemetry)
            try:
                futs, shed = trace.replay(router.submit, items)
                for fut in futs:
                    show(fut)
            finally:
                stop_flush.set()
                if flusher is not None:
                    flusher.join(timeout=10)
        out = rsnap = router.snapshot()
        print(f"[serve] router: {rsnap['requests_finished']} requests "
              f"over {rsnap['replicas']} replicas | dispatched="
              f"{[p['dispatched'] for p in rsnap['per_replica']]} "
              f"requeued={rsnap['requeued']} shed={shed} | ttft p50/p95 "
              f"{rsnap['ttft_ms']['p50']:.1f}/"
              f"{rsnap['ttft_ms']['p95']:.1f} ms | latency p50/p95 "
              f"{rsnap['latency_ms']['p50']:.1f}/"
              f"{rsnap['latency_ms']['p95']:.1f} ms | max_concurrent="
              f"{rsnap['max_concurrent_slots']}")
        for i, p in enumerate(rsnap["per_replica"]):
            e = p["engine"]
            print(f"  replica[{i}] finished="
                  f"{e['requests_finished']} occupancy="
                  f"{e['slot_occupancy']:.2f} pages_hwm="
                  f"{e['pool']['pages_hwm']}/{e['pool']['total_pages']} "
                  f"preempted={e['preempted']}")
    doc = {"schema": "repro.serve/telemetry-1", "summary": out,
           "metrics": obs_registry.snapshot()}
    if args.metrics_json:
        _write_json_atomic(args.metrics_json, doc)
        print(f"[serve] wrote {args.metrics_json}")
    if args.trace_out:
        tracer.write_chrome_trace(args.trace_out)
        print(f"[serve] wrote {args.trace_out} "
              f"({len(tracer)} trace events)")
    return doc


if __name__ == "__main__":
    main()

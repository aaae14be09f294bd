"""The port's observability layer (`repro_torch.obs`) and the engine's
observability surface, against the reference (`repro.obs`,
`tests/test_obs.py`):

* the tracer, registry and validator cases of `tests/test_obs.py`, on the
  port's copies;
* the port engine + router register exactly the reference's metric
  families (the golden list), with the same types;
* on the same page-starved speculative trace, the preempted request's lane
  reconstructs with the reference's event names in the reference's order
  (queue → admit → prefill_chunk[i] … → preempt → queue (resume) → admit →
  prefill_chunk[i] (recompute) … → finish), and the port's Chrome trace
  passes the reference's validator;
* one `compile` event and span per graph build; `reset_metrics` rebases
  the pool's high-water mark and empties the ring;
* `annotate` gates on its argument, then `REPRO_PROFILE`.

The traces run on the dense smoke arch in float32 with the reference's
weights carried into the port, so both engines take the same schedule.
"""

import json
import threading

import pytest
import torch

from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import Tracer as JTracer
from repro.obs.validate import validate_chrome_trace as jvalidate
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import Request as JRequest
from repro.serve import Router as JRouter
from repro.serve import ServeEngine as JServeEngine
from repro_torch.obs import (SNAPSHOT_SCHEMA, MetricsRegistry, NullTracer,
                             Tracer)
from repro_torch.obs.profiling import annotate, profiling_enabled
from repro_torch.obs.tracing import NULL_TRACER, TRACK_ENGINE
from repro_torch.obs.validate import (TraceValidationError,
                                      validate_chrome_trace)
from repro_torch.serve import (FaultInjector, Request, Router,
                               SamplingParams, ServeEngine)
from test_torch_serve_lifecycle import carried

ARCH = "smollm-135m-smoke"
MAX_PASSES = 400
# the reference's page-starved speculative geometry (tests/test_obs.py)
STARVED = dict(slots=2, max_len=32, page_size=8, num_pages=5,
               prefill_chunk=4, admission="incremental", spec_k=2, seed=0)


@pytest.fixture(scope="module")
def models():
    return carried(ARCH)


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

def test_tracer_ring_bound_and_drop_counter():
    tr = Tracer(capacity=4)
    for i in range(10):
        tr.instant(f"e{i}")
    assert len(tr) == 4 and tr.dropped == 6 and tr.emitted == 10
    assert [e["name"] for e in tr.events()] == ["e6", "e7", "e8", "e9"]
    tr.clear()
    assert len(tr) == 0 and tr.dropped == 0 and tr.emitted == 0
    with pytest.raises(ValueError, match="capacity"):
        Tracer(capacity=0)


def test_tracer_span_and_complete_events():
    tr = Tracer()
    with tr.span("work", pid=2, tid=5, tick=7):
        pass
    t0 = tr.now()
    tr.complete("manual", t0, t0 + 1.5, pid=1, tid=0, foo="bar")
    evs = tr.events()
    assert [e["name"] for e in evs] == ["work", "manual"]
    assert evs[0]["ph"] == "X" and evs[0]["dur"] >= 0
    assert (evs[0]["pid"], evs[0]["tid"]) == (2, 5)
    assert evs[0]["args"] == {"tick": 7}
    assert evs[1]["dur"] == 1.5
    tr.complete("backwards", 10.0, 5.0)
    assert tr.events()[-1]["dur"] == 0.0


def test_tracer_chrome_export_matches_reference_and_validates():
    """The same calls give the reference tracer's document, but for the
    timestamps."""
    docs = []
    for cls in (Tracer, JTracer):
        tr = cls()
        tr.name_process(0, "replica 0")
        tr.name_track(0, TRACK_ENGINE, "engine")
        tr.name_track(0, 3, "req 2")
        tr.complete("outer", 1.0, 9.0, pid=0, tid=3, rid=2)
        tr.complete("inner", 2.0, 3.0, pid=0, tid=3)
        tr.instant("admit", pid=0, tid=3, ts=1.0, slot=1)
        docs.append(tr.chrome_trace())
    assert docs[0] == docs[1]
    doc = docs[0]
    assert doc["displayTimeUnit"] == "ms"
    meta = {(e["name"], e["pid"], e["tid"]) for e in doc["traceEvents"]
            if e["ph"] == "M"}
    assert ("process_name", 0, 0) in meta and ("thread_name", 0, 3) in meta
    evs = validate_chrome_trace(doc)
    assert {e["name"] for e in evs} == {"outer", "inner", "admit"}
    validate_chrome_trace(json.loads(json.dumps(doc)))


def test_null_tracer_is_inert():
    nt = NullTracer()
    nt.instant("x")
    nt.complete("y", 0.0, 1.0)
    with nt.span("z"):
        pass
    nt.name_process(0, "p")
    nt.name_track(0, 0, "t")
    assert len(nt) == 0 and nt.emitted == 0 and nt.now() == 0.0
    assert not nt.enabled and not NULL_TRACER.enabled
    assert nt.chrome_trace()["traceEvents"] == []
    assert nt.span("a") is nt.span("b")


def test_engine_defaults_to_null_tracer(models):
    _, _, tcfg, model = models
    eng = ServeEngine(tcfg, model, slots=1, max_len=32, device="cpu")
    assert eng.tracer is NULL_TRACER
    assert isinstance(eng.obs, MetricsRegistry)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

def test_registry_get_or_create_identity_and_values():
    reg = MetricsRegistry()
    c = reg.counter("reqs_total", "requests")
    assert reg.counter("reqs_total") is c
    c.inc()
    c.inc(3)
    assert c.value == 4
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1)
    g = reg.gauge("depth")
    g.set(5)
    g.dec(2)
    assert g.value == 3
    h = reg.histogram("lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    v = h.value
    assert v["count"] == 3 and v["buckets"]["+Inf"] == 3
    assert v["buckets"][repr(0.1)] == 1 and v["buckets"][repr(1.0)] == 2


def test_registry_conflicts_raise():
    reg = MetricsRegistry()
    reg.counter("m")
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.gauge("m")
    with pytest.raises(ValueError, match="primitive-backed"):
        reg.register_callback("m", lambda: 1, mtype="counter")
    reg.register_callback("cb", lambda: 1)
    with pytest.raises(ValueError, match="callback-backed"):
        reg.gauge("cb")
    reg.register_callback("cb", lambda: 42)
    assert reg.snapshot()["metrics"]["cb"]["samples"][0]["value"] == 42


def test_registry_exposition_and_snapshot_match_reference():
    docs = []
    for cls in (MetricsRegistry, JMetricsRegistry):
        reg = cls()
        reg.counter("hits_total", "hit count", labels={"replica": 0}).inc(7)
        reg.counter("hits_total", labels={"replica": 1}).inc(9)
        reg.histogram("tick_seconds", "per-tick wall",
                      buckets=(0.5,)).observe(0.25)
        reg.register_callback("depth", lambda: 3.0, help="queue")
        docs.append((reg.exposition(), reg.snapshot_json()))
    assert docs[0] == docs[1]
    text = docs[0][0]
    assert 'hits_total{replica="1"} 9' in text
    assert 'tick_seconds_bucket{le="+Inf"} 1' in text
    snap = json.loads(docs[0][1])
    assert snap["schema"] == SNAPSHOT_SCHEMA == "repro.obs/v1"
    assert snap["metrics"]["depth"]["samples"][0]["value"] == 3


def test_registry_hammer_concurrent_with_exposition():
    """Four threads mutate primitives while the main thread renders; every
    render is consistent and the final counts exact."""
    reg = MetricsRegistry()
    c = reg.counter("storm_total")
    g = reg.gauge("storm_depth")
    h = reg.histogram("storm_seconds", buckets=(0.5,))
    n_threads, n_iter = 4, 2000
    start = threading.Barrier(n_threads + 1)
    errors = []

    def storm():
        try:
            start.wait(timeout=30)
            for i in range(n_iter):
                c.inc()
                g.inc()
                g.dec()
                h.observe(0.25 if i % 2 else 0.75)
        except BaseException as e:             # reported below
            errors.append(e)
            raise

    threads = [threading.Thread(target=storm) for _ in range(n_threads)]
    for t in threads:
        t.start()
    start.wait(timeout=30)
    for _ in range(200):
        snap = reg.snapshot()["metrics"]
        hv = snap["storm_seconds"]["samples"][0]["value"]
        assert hv["buckets"]["+Inf"] == hv["count"]
        assert "storm_total" in reg.exposition()
        if not any(t.is_alive() for t in threads):
            break
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    assert c.value == h.value["count"] == n_threads * n_iter
    assert g.value == 0


# ---------------------------------------------------------------------------
# Validator
# ---------------------------------------------------------------------------

def test_validator_rejects_malformed_events():
    ok = [{"name": "a", "ph": "X", "ts": 0.0, "dur": 2.0, "pid": 0,
           "tid": 0, "args": {}},
          {"name": "b", "ph": "X", "ts": 0.5, "dur": 1.0, "pid": 0,
           "tid": 0}]
    assert len(validate_chrome_trace(ok)) == 2
    for bad, why in (([{"name": "a", "ph": "i", "pid": 0, "tid": 0}],
                      "missing required"),
                     ([{"name": "a", "ph": "Q", "ts": 0, "pid": 0,
                        "tid": 0}], "unknown phase"),
                     ([{"name": "a", "ph": "X", "ts": 0, "pid": 0,
                        "tid": 0}], "without dur"),
                     ({"events": []}, "traceEvents")):
        with pytest.raises(TraceValidationError, match=why):
            validate_chrome_trace(bad)


def test_validator_rejects_partial_overlap():
    bad = [{"name": "a", "ph": "X", "ts": 0.0, "dur": 2.0, "pid": 0,
            "tid": 0},
           {"name": "b", "ph": "X", "ts": 1.0, "dur": 2.0, "pid": 0,
            "tid": 0}]
    with pytest.raises(TraceValidationError, match="partially overlaps"):
        validate_chrome_trace(bad)
    bad[1]["tid"] = 1
    validate_chrome_trace(bad)


def test_validator_cli(tmp_path, capsys):
    from repro_torch.obs import validate
    tr = Tracer()
    tr.complete("x", 0.0, 1.0)
    path = tmp_path / "t.json"
    tr.write_chrome_trace(str(path))
    assert validate.main([str(path)]) == 0
    assert "OK — 1 events (1 spans) on 1 tracks" in capsys.readouterr().out
    assert validate.main([]) == 2


# ---------------------------------------------------------------------------
# Golden schema: the reference's metric families, one registry
# ---------------------------------------------------------------------------

def test_golden_families_equal_reference(models):
    """Engine (with a fault injector) + router into one registry: the port
    registers the reference's families with the reference's types."""
    jcfg, params, tcfg, model = models
    jreg, treg_ = JMetricsRegistry(), MetricsRegistry()
    JRouter([JServeEngine(
        jcfg, params, faults=JFaultInjector(seed=3,
                                            rates={"pool.alloc": 0.0}),
        sampling=SamplingParams(), registry=jreg, replica=0, **STARVED)])
    router = Router([ServeEngine(
        tcfg, model, faults=FaultInjector(seed=3, rates={"pool.alloc": 0.0}),
        sampling=SamplingParams(), registry=treg_, replica=0, device="cpu",
        **STARVED)])
    assert len(jreg.names()) == 42
    assert treg_.names() == jreg.names()
    want = {n: f["type"] for n, f in jreg.snapshot()["metrics"].items()}
    snap = router.telemetry()
    assert snap["schema"] == "repro.serve/telemetry-1"
    assert set(snap) == {"schema", "summary", "metrics"}
    assert snap["metrics"]["schema"] == SNAPSHOT_SCHEMA
    fams = snap["metrics"]["metrics"]
    assert {n: f["type"] for n, f in fams.items()} == want
    for name, fam in fams.items():
        assert fam["samples"], f"{name} has no samples"
    sites = {s["labels"]["site"]
             for s in fams["serve_fault_calls_total"]["samples"]}
    assert sites == {"pool.alloc", "engine.tick"}
    for name in ("serve_compiles_total", "serve_compile_traces_total"):
        assert "graph builds" in fams[name]["help"]
    json.dumps(snap)


# ---------------------------------------------------------------------------
# The preempted request's timeline, port against reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def preempt_runs(models):
    """The page-starved speculative trace through a one-replica router, run
    by the reference and by the port: ``{"j": ..., "t": ...}`` of (tracer,
    registry, engine, tokens)."""
    jcfg, params, tcfg, model = models
    out = {}
    for side in ("j", "t"):
        reg = (JMetricsRegistry if side == "j" else MetricsRegistry)()
        tr = (JTracer if side == "j" else Tracer)()
        if side == "j":
            eng = JServeEngine(jcfg, params, sampling=SamplingParams(),
                               tracer=tr, registry=reg, replica=0, **STARVED)
            router = JRouter([eng], tracer=tr, registry=reg)
            req = JRequest
        else:
            eng = ServeEngine(tcfg, model, sampling=SamplingParams(),
                              tracer=tr, registry=reg, replica=0,
                              device="cpu", **STARVED)
            router = Router([eng], tracer=tr, registry=reg)
            req = Request
        futs = [router.submit(req(prompt=list(range(1, 6)),
                                  max_new_tokens=14)) for _ in range(2)]
        router.run_until_idle(max_passes=MAX_PASSES)
        out[side] = (tr, reg, eng,
                     [f.result(timeout=60).tokens for f in futs])
    return out


def _lane_of_first_preempt(events):
    pre = [e for e in events if e["name"] == "preempt"]
    assert pre, "no preempt event in trace"
    lane = [e for e in events
            if (e["pid"], e["tid"]) == (pre[0]["pid"], pre[0]["tid"])]
    lane.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
    return lane


def test_preempted_lane_matches_reference(preempt_runs):
    jtr, _, jeng, jtokens = preempt_runs["j"]
    ttr, _, teng, ttokens = preempt_runs["t"]
    assert ttokens == jtokens
    assert teng.metrics.preempted == jeng.metrics.preempted >= 1
    assert teng.metrics.draft_tokens == jeng.metrics.draft_tokens > 0
    doc = ttr.chrome_trace()
    events = validate_chrome_trace(doc)
    jvalidate(json.loads(json.dumps(doc)))          # the reference's gate
    lane = _lane_of_first_preempt(events)
    jlane = _lane_of_first_preempt(jvalidate(jtr.chrome_trace()))
    names = [e["name"] for e in lane]
    assert names == [e["name"] for e in jlane]
    stable = ("rid", "resume", "recompute", "new_tokens", "tick", "slot",
              "computed", "lo", "hi", "drafted", "accepted", "committed",
              "token", "pos")

    def args(e):
        return {k: v for k, v in e["args"].items() if k in stable}
    assert [args(e) for e in lane] == [args(e) for e in jlane]
    # the lifecycle, in order: admitted, preempted, requeued with resume,
    # recomputed, finished with all its tokens
    i_pre = names.index("preempt")
    assert names.index("queue") < names.index("admit") < i_pre
    assert any(n.startswith("prefill_chunk[") for n in names[:i_pre])
    j = i_pre + 1 + names[i_pre + 1:].index("queue")
    assert lane[j]["args"]["resume"] is True
    recompute = [e for e in lane[i_pre + 1:]
                 if e["name"].startswith("prefill_chunk[")]
    assert recompute and all(e["args"]["recompute"] for e in recompute)
    assert names[-1] == "finish" and lane[-1]["args"]["new_tokens"] == 14
    engine_lane = {e["name"] for e in events if e["tid"] == TRACK_ENGINE}
    jengine_lane = {e["name"] for e in jvalidate(jtr.chrome_trace())
                    if e["tid"] == TRACK_ENGINE}
    assert engine_lane == jengine_lane
    assert {"tick", "spec_draft", "spec_verify", "grow_pages",
            "compile", "prefill_chunk"} <= engine_lane
    meta = {(e["name"], e.get("args", {}).get("name"))
            for e in doc["traceEvents"] if e["ph"] == "M"}
    assert ("thread_name", f"req {lane[0]['args']['rid']}") in meta
    assert ("thread_name", "engine") in meta


def test_compile_events_equal_graph_builds(preempt_runs):
    tr, reg, eng, _ = preempt_runs["t"]
    events = eng.graphs.events
    assert len(events) == eng.graphs.compiles == len(eng.graphs.traces) > 0
    for ev in events:
        assert set(ev) == {"key", "seconds"}
        assert isinstance(ev["key"], str) and ev["seconds"] >= 0
    spans = [e for e in tr.events() if e["name"] == "compile"]
    assert [s["args"]["key"] for s in spans] == [ev["key"] for ev in events]
    assert all(s["cat"] == "compile" and s["tid"] == TRACK_ENGINE
               for s in spans)
    snap = reg.snapshot()["metrics"]
    for name in ("serve_compiles_total", "serve_compile_traces_total"):
        assert snap[name]["samples"][0]["value"] == eng.graphs.compiles
    assert snap["serve_tick_seconds"]["samples"][0]["value"]["count"] == \
        eng.metrics.ticks


def test_reset_metrics_rebases_pool_hwm_and_clears_trace(preempt_runs):
    tr, reg, eng, _ = preempt_runs["t"]
    before = eng.metrics.snapshot()
    assert before["pool"]["pages_hwm"] > 0 and len(tr) > 0
    eng.reset_metrics()
    after = eng.metrics.snapshot()
    assert after["pool"]["pages_hwm"] == after["pool"]["pages_in_use"] == 0
    assert after["preempted"] == 0 and after["requests_finished"] == 0
    assert len(tr) == 0 and tr.dropped == 0
    snap = reg.snapshot()["metrics"]
    assert snap["serve_preempted_total"]["samples"][0]["value"] == 0
    assert snap["serve_pages_hwm"]["samples"][0]["value"] == 0
    meta = [e for e in tr.chrome_trace()["traceEvents"] if e["ph"] == "M"]
    assert any(e["name"] == "process_name" for e in meta)


# ---------------------------------------------------------------------------
# Profiler annotations
# ---------------------------------------------------------------------------

def test_annotate_gates_on_argument_then_environment(monkeypatch):
    monkeypatch.delenv("REPRO_PROFILE", raising=False)
    assert not profiling_enabled()
    assert annotate("x") is annotate("y")          # the shared no-op
    assert profiling_enabled(True)
    cm = annotate("sandwich_matmul", enabled=True)
    assert isinstance(cm, torch.profiler.record_function)
    with cm:                                       # no profiler running
        pass
    monkeypatch.setenv("REPRO_PROFILE", "1")
    assert profiling_enabled()
    assert not profiling_enabled(False)            # the argument wins
    assert annotate("x", enabled=False) is annotate("y", enabled=False)


def test_profiled_kernel_sites_keep_results_and_name_ranges(monkeypatch):
    """With profiling on, the sandwich, butterfly and flash call sites give
    the same results, and the profiler sees the reference's range names."""
    from repro_torch.core import butterfly as bf
    from repro_torch.core import layers as blayers
    from repro_torch.kernels import butterfly as kb
    from repro_torch.kernels import flash as kf
    from repro_torch.nn import ButterflyLinear
    gen = torch.Generator().manual_seed(0)
    spec = blayers.make_spec(gen, 16, 32, k_in=4, k_out=5, use_bias=False)
    layer = ButterflyLinear(spec, generator=gen)
    w = bf.random_weights(gen, 16)
    x = torch.randn(3, 16, generator=gen)
    q = torch.randn(1, 2, 5, 8, generator=gen)

    def run():
        with torch.no_grad():
            return (layer(x), kb.butterfly_forward(x, w),
                    kf.flash_attention(q, q, q))

    monkeypatch.delenv("REPRO_PROFILE", raising=False)
    want = run()
    monkeypatch.setenv("REPRO_PROFILE", "1")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = run()
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)
    names = {e.key for e in prof.key_averages()}
    assert {"sandwich_matmul", "butterfly_matmul",
            "flash_attention"} <= names

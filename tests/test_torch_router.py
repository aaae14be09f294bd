"""The port's multi-replica tier (`repro_torch.serve.router`) against the
reference's (`repro.serve.router`), on the traces of the reference's
`tests/test_router.py` and its four properties:

(a) scale-out — under overload, two replicas with the same page memory as
    one reach a higher concurrency and drain in fewer driver passes;
(b) losslessness — drain and a hot swap from a checkpoint the reference's
    `CheckpointManager` wrote, its newest step torn, drop nothing and keep
    the greedy tokens;
(c) typed backpressure — `QueueFull` fails over; the tier sheds only when
    every live replica sheds;
(d) fault isolation — a replica whose tick raises is routed around.

Each tier runs twice, the reference's router over its engines and the
port's over its engines, with the reference's weights carried into the
port (float32, CPU) and every engine of a port tier on its own copy of
them. They must give the same dispatch (per-replica `dispatched` and
`shed`), the same tier counters and the same greedy tokens (or the same
failure) per request. The hot swap runs on the butterfly smoke arch, whose
engines hold the reference's truncation-index sets: a swap that replaced
them with the port's own would change the tokens. Driver loops are bounded
by passes (`MAX_PASSES`); every `result()` has a timeout.
"""

import copy

import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointing import CheckpointManager as JCkpt
from repro.serve import QueueFull as JQueueFull
from repro.serve import Request as JRequest
from repro.serve import Router as JRouter
from repro.serve import ServeEngine as JServeEngine
from repro.serve.faults import tear_checkpoint as jtear
from repro_torch.serve import (QueueFull, Request, RequestCancelled, Router,
                               ServeEngine)
from repro_torch.serve import trace as trace_lib
from test_torch_serve_lifecycle import carried
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

ARCH = "smollm-135m-smoke"
MAX_PASSES = 400
TIMEOUT = 300
ENGINE_KW = dict(slots=2, max_len=32, page_size=8, prefill_chunk=4)
COUNTERS = ("requeued", "shed", "drains", "swaps", "passes",
            "max_concurrent")


@pytest.fixture(scope="module")
def models():
    return carried(ARCH)


@pytest.fixture(scope="module")
def bfly_models():
    from test_torch_lm import carried_models
    return carried_models(seed=1)


def _prompts(cfg, n, length=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=length).astype(np.int32)
            for _ in range(n)]


def _outcome(fut):
    try:
        return fut.result(timeout=TIMEOUT).tokens
    except Exception as e:                  # noqa: BLE001 — compared by type
        return type(e).__name__


class Tier:
    """The reference's router and the port's, over replicas built with the
    same keyword arguments (``per_replica``: one dict per replica)."""

    def __init__(self, models, per_replica, **router_kw):
        jcfg, params, tcfg, model = models
        self.cfg = jcfg
        kws = [{**ENGINE_KW, **kw} for kw in per_replica]
        self.j = JRouter([JServeEngine(jcfg, params, seed=0, **kw)
                          for kw in kws], **router_kw)
        self.t = Router([ServeEngine(tcfg, copy.deepcopy(model), seed=0,
                                     device="cpu", **kw)
                         for kw in kws], **router_kw)
        self.futs = []

    def submit(self, prompt, max_new):
        pair = (self.j.submit(JRequest(prompt=prompt,
                                       max_new_tokens=max_new)),
                self.t.submit(Request(prompt=prompt,
                                      max_new_tokens=max_new)))
        self.futs.append(pair)
        return pair

    def both(self, fn):
        return fn(self.j), fn(self.t)

    def step(self):
        self.both(lambda r: r.step())

    def run(self):
        return self.both(lambda r: r.run_until_idle(max_passes=MAX_PASSES))

    def check(self):
        """Same dispatch, counters and outcomes; returns the outcomes."""
        for key in ("dispatched", "shed"):
            want, got = self.both(
                lambda r: [getattr(x, key) for x in r.replicas])
            assert got == want, (key, got, want)
        for key in COUNTERS:
            want, got = self.both(lambda r: getattr(r, key))
            assert got == want, (key, got, want)
        outcomes = [(_outcome(j), _outcome(t)) for j, t in self.futs]
        for i, (j, t) in enumerate(outcomes):
            assert t == j, f"request {i}: port {t} != reference {j}"
        return [t for _, t in outcomes]


def test_router_validates_geometry_weights_and_models(models):
    _, _, tcfg, model = models

    def eng(**kw):
        return ServeEngine(tcfg, copy.deepcopy(model), device="cpu",
                           **{**ENGINE_KW, **kw})
    e1, e2 = eng(), eng()
    with pytest.raises(ValueError, match="at least one"):
        Router([])
    with pytest.raises(ValueError, match="distinct"):
        Router([e1, e1])
    with pytest.raises(ValueError, match="uniform"):
        Router([e1, eng(max_len=64)])
    with pytest.raises(ValueError, match="weights"):
        Router([e1, e2], weights=[1.0])
    with pytest.raises(ValueError, match="positive"):
        Router([e1, e2], weights=[1.0, 0.0])
    shared = ServeEngine(tcfg, e1.model, device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="distinct models"):
        Router([e1, shared])


@pytest.mark.parametrize("weights,split", [(None, [2, 2]),
                                           ([3.0, 1.0], [3, 1])])
def test_dispatch_order_matches_reference(models, weights, split):
    """Least-outstanding dispatch (ties to the lower index), and a weight-3
    replica absorbing three before the weight-1 one wins a tie: the same
    replica per request as the reference's router."""
    tier = Tier(models, [{}, {}], weights=weights)
    for p in _prompts(tier.cfg, 4):
        tier.submit(p, 2)
    owners = tier.both(lambda r: dict(r._owner))
    assert owners[1] == owners[0]
    assert [r.dispatched for r in tier.t.replicas] == split
    tier.run()
    tier.check()


def test_queue_full_fails_over_then_sheds(models):
    """Property (c): r0 (weight 4, queue 1) takes #0, r1 #1, #2 sheds off
    full r0 onto r1, #3 finds every replica full and the tier sheds."""
    tier = Tier(models, [dict(slots=1, queue_limit=1),
                         dict(slots=1, queue_limit=2)], weights=[4.0, 1.0])
    prompts = _prompts(tier.cfg, 4)
    for p in prompts[:3]:
        tier.submit(p, 2)
    assert tier.t.replicas[0].shed == 1
    assert [r.dispatched for r in tier.t.replicas] == [1, 2]
    with pytest.raises(JQueueFull):
        tier.j.submit(JRequest(prompt=prompts[3], max_new_tokens=2))
    with pytest.raises(QueueFull):
        tier.t.submit(Request(prompt=prompts[3], max_new_tokens=2))
    assert tier.t.shed == 1
    tier.run()
    assert all(len(t) == 2 for t in tier.check())


def test_two_replicas_beat_one_at_equal_pages(models):
    """Property (a): 8 usable pages as one replica against 4 + 4 over two;
    each request needs 2 pages, so the tier reaches 4 concurrent slots and
    drains in fewer passes than the single engine's ticks, with the single
    engine's tokens; the same passes as the reference's tier."""
    jcfg, params, tcfg, model = models
    prompts = _prompts(jcfg, 8)
    single = ServeEngine(tcfg, copy.deepcopy(model), device="cpu",
                         **{**ENGINE_KW, "num_pages": 9})
    sfuts = [single.submit(Request(prompt=p, max_new_tokens=8))
             for p in prompts]
    ticks = single.run_until_idle(max_ticks=MAX_PASSES)
    assert single.metrics.snapshot()["max_concurrent_slots"] == 2
    tier = Tier(models, [dict(num_pages=5), dict(num_pages=5)])
    for p in prompts:
        tier.submit(p, 8)
    jpasses, tpasses = tier.run()
    assert tpasses == jpasses < ticks
    assert tier.t.snapshot()["max_concurrent_slots"] == 4
    got = tier.check()
    assert got == [f.result(timeout=TIMEOUT).tokens for f in sfuts]


def test_drain_hot_swap_from_reference_checkpoint_keeps_index_sets(
        bfly_models, tmp_path):
    """Property (b) on the butterfly smoke arch: the reference's
    CheckpointManager writes steps 1 and 2, step 2 is torn, and replica 0
    swaps mid-flight in both tiers: the swap restores step 1, nothing is
    dropped, the tokens equal the reference tier's, also those the swapped
    replica serves after the swap, and the port replica's truncation-index
    buffers are the ones it held (the reference's)."""
    jcfg, params, _, _ = bfly_models
    mgr = JCkpt(str(tmp_path))
    mgr.save(1, {"params": params})
    mgr.save(2, {"params": params})
    jtear(str(tmp_path))
    tier = Tier(bfly_models, [{}, {}])
    held = {n: b.clone() for n, b in
            tier.t.replicas[0].engine.model.named_buffers()}
    assert held, "the butterfly engine must hold index sets"
    for p in _prompts(jcfg, 6, seed=1):
        tier.submit(p, 6)
    tier.step()
    assert tier.t.replicas[0].engine.has_work()
    steps = tier.both(lambda r: r.swap_checkpoint(0, str(tmp_path),
                                                  timeout=TIMEOUT))
    assert steps == (1, 1)
    assert not tier.t.replicas[0].draining
    # the drain moved replica 0's queue away: serve more after the swap,
    # so the swapped replica's own tokens are compared too
    after = tier.t.replicas[0].dispatched
    for p in _prompts(jcfg, 4, seed=2):
        tier.submit(p, 6)
    assert tier.t.replicas[0].dispatched > after
    tier.run()
    got = tier.check()
    assert len(got) == 10 and all(len(t) == 6 for t in got)
    for n, b in tier.t.replicas[0].engine.model.named_buffers():
        assert torch.equal(b, held[n]), n
    assert tier.t.snapshot()["requests_finished"] == 10


def test_drain_moves_queued_work_and_undrain_restores(models):
    tier = Tier(models, [dict(slots=1), dict(slots=1)])
    prompts = _prompts(tier.cfg, 4)
    for p in prompts:
        tier.submit(p, 2)
    tier.both(lambda r: r.drain(0))
    tier.step()
    assert tier.t.requeued >= 1
    tier.submit(prompts[0], 2)
    assert tier.t.replicas[1].dispatched == 3   # draining replica skipped
    tier.both(lambda r: r.wait_drained(0, timeout=TIMEOUT))
    tier.both(lambda r: r.undrain(0))
    tier.run()
    tier.check()


def test_swap_checkpoint_failure_keeps_replica_serving(models, tmp_path):
    jcfg, _, tcfg, model = models
    router = Router([ServeEngine(tcfg, copy.deepcopy(model), device="cpu",
                                 **ENGINE_KW) for _ in range(2)])
    with pytest.raises(FileNotFoundError, match="no restorable"):
        router.swap_checkpoint(0, str(tmp_path / "nothing_here"))
    assert not router.replicas[0].draining
    with pytest.raises(RuntimeError, match="not draining"):
        router.wait_drained(0)
    fut = router.submit(Request(prompt=_prompts(jcfg, 1)[0],
                                max_new_tokens=2))
    router.run_until_idle(max_passes=MAX_PASSES)
    assert len(fut.result(timeout=TIMEOUT).tokens) == 2


def test_cancel_follows_requeued_request(models):
    """Cancel after requeue: rid 2 lands on replica 0, the drain moves it to
    replica 1, and cancel finds it there; the other requests' tokens equal
    the reference tier's."""
    tier = Tier(models, [dict(slots=1), dict(slots=1)])
    for p in _prompts(tier.cfg, 4):
        tier.submit(p, 4)
    assert tier.t._owner[2] == tier.j._owner[2] == 0
    tier.both(lambda r: r.drain(0))
    tier.step()
    assert tier.t._owner[2] == tier.j._owner[2] == 1
    assert tier.both(lambda r: r.cancel(2)) == (True, True)
    tier.both(lambda r: r.undrain(0))
    tier.run()
    got = tier.check()
    assert got.count("RequestCancelled") == 1 and got[2] == \
        "RequestCancelled"
    with pytest.raises(RequestCancelled):
        tier.futs[2][1].result(timeout=TIMEOUT)


def test_replica_crash_fails_inflight_and_requeues_queued(models):
    """Property (d): replica 0's tick raises mid-run in both tiers: its
    in-flight request fails with the real error, its queued one requeues,
    the tier keeps serving and never dispatches to it again."""
    tier = Tier(models, [dict(slots=1), dict(slots=1)])
    prompts = _prompts(tier.cfg, 4)
    for p in prompts:
        tier.submit(p, 4)
    tier.step()
    booms = {}
    for name, router in zip("jt", (tier.j, tier.t)):
        boom = booms[name] = RuntimeError("device melted")

        def bad_step(boom=boom):
            raise boom
        router.replicas[0].engine.step = bad_step
    tier.step()
    assert tier.t.replicas[0].dead is booms["t"]
    assert tier.t.requeued >= 1
    tier.run()
    got = tier.check()
    assert got.count("RuntimeError") == 1
    with pytest.raises(RuntimeError) as ei:
        next(t for _, t in tier.futs if t.exception(timeout=TIMEOUT)
             ).result(timeout=TIMEOUT)
    assert ei.value is booms["t"]          # the real error, not a wrapper
    tier.submit(prompts[0], 2)
    assert tier.t.replicas[1].dispatched >= 3
    tier.run()
    tier.check()
    assert tier.t.snapshot()["per_replica"][0]["dead"] is not None


def test_all_replicas_dead_refuses_submits(models):
    jcfg, _, tcfg, model = models
    eng = ServeEngine(tcfg, copy.deepcopy(model), device="cpu",
                      **{**ENGINE_KW, "slots": 1})
    router = Router([eng])
    fut = router.submit(Request(prompt=_prompts(jcfg, 1)[0],
                                max_new_tokens=2))
    eng.step = lambda: (_ for _ in ()).throw(RuntimeError("rip"))
    router.step()
    with pytest.raises(RuntimeError, match="rip"):
        fut.result(timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="no live replica"):
        router.submit(Request(prompt=_prompts(jcfg, 1)[0],
                              max_new_tokens=2))


def test_async_router_serves_open_loop_trace(models):
    """``with router:`` attaches one driver thread over both replicas; an
    open-loop trace replayed against wall-clock arrivals gives the
    synchronous run's tokens; submitting after close raises."""
    jcfg, _, tcfg, model = models
    items = trace_lib.generate(
        trace_lib.TraceSpec(requests=6, seed=3, rate=200.0, min_prompt=4,
                            max_prompt=12, max_new_tokens=4),
        jcfg.vocab_size)

    def tier():
        return Router([ServeEngine(tcfg, copy.deepcopy(model), device="cpu",
                                   **ENGINE_KW) for _ in range(2)])
    sync = tier()
    sfuts = [sync.submit(it.request()) for it in items]
    sync.run_until_idle(max_passes=MAX_PASSES)
    want = [f.result(timeout=TIMEOUT).tokens for f in sfuts]
    router = tier()
    try:
        with router:
            futs, shed = trace_lib.replay(router.submit, items)
            got = [f.result(timeout=TIMEOUT).tokens for f in futs]
    finally:
        router.close()
    assert shed == 0 and got == want
    with pytest.raises(RuntimeError, match="closed"):
        router.submit(items[0].request())


def test_snapshot_and_telemetry_shape(models):
    import json
    tier = Tier(models, [{}, {}])
    for p in _prompts(tier.cfg, 4):
        tier.submit(p, 3)
    tier.run()
    tier.check()
    snap = tier.t.snapshot()
    json.dumps(snap)
    jsnap = tier.j.snapshot()
    for key in ("replicas", "requests_finished", "max_concurrent_slots",
                "requeued", "shed", "drains", "swaps", "passes"):
        assert snap[key] == jsnap[key], key
    assert snap["ttft_ms"]["p50"] <= snap["ttft_ms"]["p95"]
    assert snap["latency_ms"]["p50"] <= snap["latency_ms"]["p95"]
    assert sum(p["dispatched"] for p in snap["per_replica"]) == 4
    tel = tier.t.telemetry()
    assert tel["schema"] == "repro.serve/telemetry-1"
    fams = tel["metrics"]["metrics"]
    assert fams["router_passes_total"]["samples"][0]["value"] == \
        snap["passes"]

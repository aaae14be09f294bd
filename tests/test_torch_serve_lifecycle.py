"""The port's serving lifecycle against the JAX reference: incremental
admission with preemption and recompute, scrub-on-free, cancel, deadlines,
the bounded queue, fault injection and torn checkpoints.

Each engine test runs the reference's unsharded `ServeEngine` and the
port's on the same trace, with the reference's weights carried into the
port (`repro_torch.convert`), in float32 on the CPU. They must give the
same greedy tokens (or the same typed failure) per request, and their
snapshots the same `preempted`, `recompute_tokens`, `cancelled`,
`deadline_expired`, `rejected_queue_full` and `max_concurrent_slots`.
The traces are those of the reference's own tests
(`tests/test_serve.py`, `tests/test_serve_faults.py`), which hold the
reference against its single-request oracle. Every test that drives
ticks bounds them (`MAX_TICKS`).
"""

import copy
import time

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointing import CheckpointManager as JCkpt
from repro.configs import registry as jreg
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import loader as jloader
from repro.serve.faults import tear_checkpoint as jtear
from repro_torch import convert
from repro_torch.checkpoint.checkpointing import CheckpointManager, load_latest
from repro_torch.configs import registry as treg
from repro_torch.serve import (DeadlineExceeded, FaultInjector, InjectedFault,
                               PoolExhausted, QueueFull, Request,
                               RequestCancelled, ServeEngine)
from repro_torch.serve.faults import SITES, tear_checkpoint
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

ARCH = "smollm-135m-smoke"
MAX_TICKS = 400
COUNTERS = ("preempted", "recompute_tokens", "cancelled", "deadline_expired",
            "rejected_queue_full", "max_concurrent_slots")
# the reference's fault-test geometry (tests/test_serve_faults.py:_engine)
FAULT_KW = dict(slots=2, max_len=32, page_size=8, prefill_chunk=4)
# a page-starved pool: 4 usable 8-token pages, chunks of 4
STARVED_KW = dict(slots=2, max_len=32, page_size=8, num_pages=5,
                  prefill_chunk=4, admission="incremental")


def carried(arch, seed=0):
    """(jax cfg, jax params, port cfg, port model): the reference's init
    carried into the port, both computing in float32."""
    from test_torch_lm import reference_site_specs
    jcfg = jreg.get(arch).with_(compute_dtype="float32")
    tcfg = treg.get(arch).with_(compute_dtype="float32")
    params = jloader.init_params(jcfg, seed=seed)
    specs = reference_site_specs(jcfg) if jcfg.butterfly else {}
    model = convert.from_jax_params(
        tcfg, jax.tree_util.tree_map(np.asarray, params), specs,
        device="cpu")
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def models():
    return carried(ARCH)


class Pair:
    """The reference engine and the port's, built with the same keyword
    arguments; ``faults`` (a callable making one injector) gives each its
    own injector on the same schedule."""

    def __init__(self, models, faults=None, **kw):
        jcfg, params, tcfg, model = models
        self.cfg = jcfg
        self.j = JServeEngine(jcfg, params, seed=0, **kw,
                              faults=faults(JFaultInjector) if faults
                              else None)
        self.t = ServeEngine(tcfg, model, seed=0, device="cpu", **kw,
                             faults=faults(FaultInjector) if faults
                             else None)
        self.futs = []

    def submit(self, prompt, max_new, **kw):
        self.futs.append((
            self.j.submit(JRequest(prompt=prompt, max_new_tokens=max_new,
                                   **kw)),
            self.t.submit(Request(prompt=prompt, max_new_tokens=max_new,
                                  **kw))))
        return self.futs[-1]

    def step(self, n=1):
        for _ in range(n):
            self.j.step()
            self.t.step()

    def run(self):
        self.j.run_until_idle(max_ticks=MAX_TICKS)
        self.t.run_until_idle(max_ticks=MAX_TICKS)

    def outcomes(self):
        """Per request, (reference, port): tokens, or the failure's type
        name and the fields a failure carries."""
        return [(_outcome(j), _outcome(t)) for j, t in self.futs]

    def check(self):
        """Same outcome per request, same lifecycle counters; returns the
        port's snapshot."""
        for i, (j, t) in enumerate(self.outcomes()):
            assert t == j, f"request {i}: port {t} != reference {j}"
        js, ts = self.j.metrics.snapshot(), self.t.metrics.snapshot()
        for key in COUNTERS:
            assert ts[key] == js[key], (key, ts[key], js[key])
        assert ts["pool"]["pages_in_use"] == js["pool"]["pages_in_use"]
        return ts


def _outcome(fut):
    exc = fut.exception(timeout=0)
    if exc is None:
        return fut.result(timeout=0).tokens
    return (type(exc).__name__, getattr(exc, "rid", None),
            getattr(exc, "site", None))


def _prompt(cfg, n, rng):
    return rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)


def _fault_prompt(cfg, n=5, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=n).astype(np.int32)


def _page_content(eng, pages):
    return torch.cat([pool[:, list(pages)].reshape(-1)
                      for pool in eng.caches.values()])


# ---------------------------------------------------------------------------
# Incremental admission: preemption and recompute
# ---------------------------------------------------------------------------

def test_preempted_request_resumes_token_identical(models):
    """Two 5-token prompts, 14 new tokens each, on 4 usable 8-token pages:
    the younger request is preempted and recomputed; tokens and counters
    equal the reference's, every page drains."""
    pair = Pair(models, **STARVED_KW)
    rng = np.random.default_rng(11)
    for _ in range(2):
        pair.submit(_prompt(pair.cfg, 5, rng), 14)
    pair.run()
    snap = pair.check()
    assert snap["preempted"] >= 1 and snap["recompute_tokens"] > 0
    results = [t.result(0) for _, t in pair.futs]
    assert sum(r.metrics.preemptions for r in results) == snap["preempted"]
    assert pair.t.pool.pages_in_use == 0
    assert len(pair.t.pool.free_list()) == pair.t.pool.total_pages - 1


@pytest.mark.parametrize("admission", ["eager", "incremental"])
def test_incremental_admits_mixed_trace_eager_cannot(models, admission):
    """A long request (3-page budget) and a short one (2 pages) on 4 usable
    pages: eager admission serializes them, incremental co-runs them, with
    the same tokens as the reference under either policy."""
    pair = Pair(models, **{**STARVED_KW, "admission": admission})
    rng = np.random.default_rng(12)
    pair.submit(_prompt(pair.cfg, 5, rng), 14)
    pair.submit(_prompt(pair.cfg, 4, rng), 6)
    pair.run()
    snap = pair.check()
    assert snap["max_concurrent_slots"] == (1 if admission == "eager" else 2)
    assert snap["pool"]["admission"] == admission
    if admission == "eager":
        assert snap["preempted"] == 0


def test_incremental_requires_paged_chunked(models):
    """The recompute path rides chunked prefill on the paged pool; both
    engines reject anything else at construction."""
    jcfg, params, tcfg, model = models
    for kw in (dict(pool="dense"), dict(prefill_chunk=None)):
        with pytest.raises(ValueError, match="incremental"):
            JServeEngine(jcfg, params, slots=2, max_len=32,
                         admission="incremental", **kw)
    for kw in (dict(pool="dense"), dict(prefill_chunk=None)):
        with pytest.raises(ValueError, match="incremental"):
            ServeEngine(tcfg, model, slots=2, max_len=32, device="cpu",
                        admission="incremental", **kw)
    with pytest.raises(ValueError, match="admission"):
        ServeEngine(tcfg, model, slots=2, max_len=32, device="cpu",
                    admission="lazy")


def test_preempt_resume_metrics_survive(models):
    """After a preempt-and-resume cycle every counter reflects the
    requests' real lives: one prefill each, every token counted once, TTFT
    from the first admission."""
    pair = Pair(models, **STARVED_KW)
    rng = np.random.default_rng(32)
    for _ in range(2):
        pair.submit(_prompt(pair.cfg, 5, rng), 14)
    pair.run()
    snap = pair.check()
    assert snap["preempted"] >= 1
    assert snap["prefills"] == pair.j.metrics.snapshot()["prefills"] == 2
    for _, t in pair.futs:
        r = t.result(0)
        assert r.metrics.new_tokens == len(r.tokens) == 14
        assert 0 < r.metrics.ttft <= r.metrics.latency


# ---------------------------------------------------------------------------
# Scrub-on-free
# ---------------------------------------------------------------------------

def test_scrubbed_slots_do_not_change_outputs(models):
    """Zeroing freed slots' pages between requests changes no token."""
    pair = Pair(models, slots=2, max_len=64, scrub_freed_slots=True)
    rng = np.random.default_rng(4)
    for n in (4, 11, 6, 8):
        pair.submit(_prompt(pair.cfg, n, rng), 5)
    pair.run()
    pair.check()


@pytest.mark.parametrize("exit_path", ["cancel", "deadline", "preempt"])
def test_lifecycle_exits_scrub_freed_pages(models, exit_path):
    """Cancel, deadline and preempt run the same scrub-then-free tail as a
    finish: the freed pages read back zero, on the port's pool, and the
    request's outcome and counters equal the reference's. Ticks are counted,
    not timed: the deadline is in ticks and every loop is bounded."""
    kw = dict(slots=1, max_len=64, scrub_freed_slots=True)
    if exit_path == "preempt":
        kw.update(admission="incremental")
    pair = Pair(models, **kw)
    rng = np.random.default_rng(31)
    pair.submit(_prompt(pair.cfg, 6, rng), 16,
                deadline_ticks=4 if exit_path == "deadline" else None)
    pair.step(3)                        # prefill + two decode ticks
    pages = pair.t.pool.slot_pages(0)
    assert pages and float(_page_content(pair.t, pages).abs().max()) > 0
    if exit_path == "cancel":
        rid = pair.t.active_requests()[0]
        assert pair.j.cancel(rid) and pair.t.cancel(rid)
        pair.step()
    elif exit_path == "deadline":
        for _ in range(4):              # ticks reach deadline_ticks=4
            if pair.futs[0][1].done():
                break
            pair.step()
        assert pair.futs[0][0].done() and pair.futs[0][1].done()
    else:
        pair.j._preempt(0)              # white-box: the page-kick path
        pair.t._preempt(0)
    assert pair.t.pool.slot_pages(0) == ()
    assert float(_page_content(pair.t, pages).abs().max()) == 0, \
        f"{exit_path} left KV in recycled pages"
    pair.run()
    pair.check()


# ---------------------------------------------------------------------------
# One build per key
# ---------------------------------------------------------------------------

def test_chunked_prefill_builds_once_for_all_lengths(models):
    """Prompts of one, two and three chunks share one chunk-prefill build
    and one decode build: the reference's compile keys less its eager
    first-token sampler (the port samples outside its graphs)."""
    pair = Pair(models, slots=2, max_len=64)
    rng = np.random.default_rng(2)
    for n in (5, 7, 20, 3, 40):
        pair.submit(_prompt(pair.cfg, n, rng), 2)
    pair.run()
    pair.check()
    stats = pair.t.compile_stats
    name = pair.cfg.name
    chunk = ("chunk_prefill", name, 2, 16)
    decode = ("decode", name, 2, "paged", pair.t.sampling)
    assert stats["traces"] == {chunk: 1, decode: 1}
    assert stats["compiles"] == 2
    jkeys = {k[:-1] for k in pair.j.compile_stats["traces"]
             if k[0] != "sample"}
    assert jkeys == {chunk, ("decode", name, 2, "paged", pair.j.sampling)}
    snap = pair.t.metrics.snapshot()
    assert stats["replays"] == {chunk: snap["chunk_ticks"] - 1,
                                decode: snap["decode_steps"] - 1}


def test_build_ticks_are_set_up_apart_from_the_steady_rate(models):
    """The ticks that built a graph entry (one per key) are counted, timed
    apart as set-up, and left out of the steady decode rate."""
    pair = Pair(models, slots=2, max_len=64)
    rng = np.random.default_rng(2)
    for n in (5, 20, 3):
        pair.submit(_prompt(pair.cfg, n, rng), 6)
    pair.run()
    pair.check()
    m = pair.t.metrics
    snap = m.snapshot()
    assert snap["build"]["ticks"] == pair.t.compile_stats["compiles"] == 2
    assert 0 < snap["build"]["time_s"] <= m.decode_time_s + m.prefill_time_s
    steady = ((m.decode_tokens - m.build_decode_tokens)
              / (m.decode_time_s - m.build_decode_time_s))
    assert snap["decode_tok_per_s_steady"] == steady > 0
    # the first decode tick decodes the 5-token prompt's slot alone: the
    # 20-token prompt takes a second chunk
    assert m.build_decode_tokens == 1


# ---------------------------------------------------------------------------
# Cancel, deadlines, the bounded queue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["queued", "in_flight", "unknown"])
def test_cancel(models, case):
    """A cancelled request resolves with RequestCancelled and frees its
    slot and pages; an unknown rid is a no-op; the rest still finish."""
    pair = Pair(models, **{**FAULT_KW, "slots": 1 if case == "queued"
                           else 2})
    cfg = pair.cfg
    if case == "unknown":
        assert not pair.j.cancel(12345) and not pair.t.cancel(12345)
        return
    if case == "queued":
        pair.submit(_fault_prompt(cfg), 6)
        pair.submit(_fault_prompt(cfg, seed=1), 6, rid=42)
        assert pair.j.cancel(42) and pair.t.cancel(42)
    else:
        pair.submit(_fault_prompt(cfg), 20, rid=7)
        pair.step(4)
        assert 7 in pair.t.active_requests()
        assert pair.j.cancel(7) and pair.t.cancel(7)
    pair.run()
    snap = pair.check()
    assert snap["cancelled"] == 1
    with pytest.raises(RequestCancelled):
        pair.futs[-1][1].result(0)
    assert pair.t.active_requests() == [] and pair.t.pool.pages_in_use == 0


@pytest.mark.parametrize("case", ["queued", "in_flight", "wall", "generous"])
def test_deadlines(models, case):
    """Deadlines in ticks (queued and in flight) and in wall seconds fail
    with DeadlineExceeded and free slot and pages; a generous one
    finishes."""
    pair = Pair(models, **{**FAULT_KW, "slots": 1 if case == "queued"
                           else 2})
    cfg = pair.cfg
    if case == "queued":
        pair.submit(_fault_prompt(cfg), 20)
        pair.submit(_fault_prompt(cfg, seed=1), 4, deadline_ticks=3)
    elif case == "in_flight":
        pair.submit(_fault_prompt(cfg), 20, deadline_ticks=5)
    elif case == "wall":
        pair.submit(_fault_prompt(cfg), 4, deadline_s=0.001)
        time.sleep(0.01)                # blow the SLO before any tick
    else:
        pair.submit(_fault_prompt(cfg), 4, deadline_ticks=10_000,
                    deadline_s=600.0)
    pair.run()
    snap = pair.check()
    assert snap["deadline_expired"] == (case != "generous")
    if case != "generous":
        with pytest.raises(DeadlineExceeded,
                           match="deadline_s" if case == "wall"
                           else "deadline_ticks"):
            pair.futs[-1][1].result(0)
    assert pair.t.active_requests() == [] and pair.t.pool.pages_in_use == 0


def test_request_validation():
    """Deadlines must be positive, as in the reference; ``extras`` takes
    ``frontend_embeds`` and ``frames``, each (1, n, d), kept as float32."""
    for kw in (dict(deadline_ticks=0), dict(deadline_s=-1.0)):
        name = next(iter(kw))
        with pytest.raises(ValueError, match=name):
            JRequest(prompt=[1], **kw)
        with pytest.raises(ValueError, match=name):
            Request(prompt=[1], **kw)
    with pytest.raises(ValueError, match="extras"):
        Request(prompt=[1], extras={"frontend_embeds": np.zeros(3)})
    with pytest.raises(ValueError, match="unknown inputs"):
        Request(prompt=[1], extras={"pixels": np.zeros((1, 2, 3))})
    with pytest.raises(ValueError, match="mapping"):
        Request(prompt=[1], extras=[np.zeros((1, 2, 3))])
    req = Request(prompt=[1], extras={"frames": np.zeros((1, 2, 3))})
    assert req.extras["frames"].dtype == np.float32


def test_queue_full_sheds_typed(models):
    """A submit past ``queue_limit`` queued requests raises QueueFull; the
    queued ones still complete; a limit below 1 is refused."""
    pair = Pair(models, **FAULT_KW, queue_limit=2)
    cfg = pair.cfg
    pair.submit(_fault_prompt(cfg), 2)
    pair.submit(_fault_prompt(cfg, seed=1), 2)
    with pytest.raises(QueueFull, match="2 requests waiting"):
        pair.t.submit(Request(prompt=_fault_prompt(cfg, seed=2),
                              max_new_tokens=2))
    with pytest.raises(Exception, match="2 requests waiting"):
        pair.j.submit(JRequest(prompt=_fault_prompt(cfg, seed=2),
                               max_new_tokens=2))
    pair.run()
    snap = pair.check()
    assert snap["rejected_queue_full"] == 1
    assert pair.t.metrics.requests_finished == 2
    _, _, tcfg, model = models
    with pytest.raises(ValueError, match="queue_limit"):
        ServeEngine(tcfg, model, device="cpu", **FAULT_KW, queue_limit=0)


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

def _fired(inj, exc_type, site="pool.alloc", calls=200):
    out = []
    for i in range(1, calls + 1):
        try:
            inj.check(site)
        except exc_type as e:
            out.append((i, type(e).__name__))
    return out


@pytest.mark.parametrize("schedule", [
    dict(seed=7, rates={"pool.alloc": 0.1}),
    dict(seed=8, rates={"pool.alloc": 0.1}),
    dict(seed=3, rates={"pool.alloc": 0.05}, at={"pool.alloc": (4,)}),
    dict(at={"engine.tick": (2, 5)}),
])
def test_fault_injector_schedule(schedule):
    """Given seed and call sequence, the port's injector fires at the
    reference's ordinals with the same exception types and summary."""
    site = next(iter({**schedule.get("rates", {}),
                      **schedule.get("at", {})}))
    ref, port = JFaultInjector(**schedule), FaultInjector(**schedule)
    got = _fired(port, RuntimeError, site)
    assert got and got == _fired(ref, RuntimeError, site)
    assert port.summary() == ref.summary()
    want_type = "PoolExhausted" if site == "pool.alloc" else "InjectedFault"
    assert {name for _, name in got} == {want_type}


def test_fault_injector_validation():
    assert SITES == ("pool.alloc", "engine.tick")
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector(rates={"pool.allocate": 0.1})
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector(at={"tick": (1,)})
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        FaultInjector(rates={"pool.alloc": 1.5})
    with pytest.raises(PoolExhausted, match="injected"):
        FaultInjector(at={"pool.alloc": (1,)}).check("pool.alloc")


@pytest.mark.parametrize("admission", ["eager", "incremental"])
def test_forced_pool_alloc(models, admission):
    """A forced PoolExhausted at the 2nd allocation: under eager admission
    it defers the 2nd request (no preemption), under incremental it
    preempts the decoding slot, which recomputes; tokens equal the
    reference's and the unfaulted run's."""
    kw = dict(FAULT_KW, admission=admission)
    n_req, max_new = (2, 6) if admission == "eager" else (1, 10)
    if admission == "incremental":
        kw.update(num_pages=9)
    clean = Pair(models, **kw)
    pair = Pair(models, **kw,
                faults=lambda cls: cls(at={"pool.alloc": (2,)}))
    for p in (clean, pair):
        for s in range(n_req):
            p.submit(_fault_prompt(p.cfg, seed=s), max_new)
        p.run()
    snap = pair.check()
    assert [t for _, t in pair.outcomes()] == \
        [t for _, t in clean.outcomes()]
    assert pair.t.faults.fired["pool.alloc"] == 1
    assert snap["pool"]["exhausted_events"] >= 1
    assert snap["preempted"] == (admission == "incremental")
    assert snap["pool"]["pages_in_use"] == 0


def test_engine_tick_fault_abort_all_fails_futures(models):
    """An ``engine.tick`` fault is a crash: it propagates out of ``step``;
    the loop's ``abort_all`` fails every future with it and empties the
    slots; the engine then serves new requests."""
    pair = Pair(models, **FAULT_KW,
                faults=lambda cls: cls(at={"engine.tick": (2,)}))
    cfg = pair.cfg
    pair.submit(_fault_prompt(cfg), 4)
    pair.submit(_fault_prompt(cfg, seed=1), 4)
    pair.step()
    for eng in (pair.j, pair.t):
        with pytest.raises(Exception, match="engine.tick") as ei:
            eng.step()
        eng.abort_all(ei.value)
    assert isinstance(ei.value, InjectedFault) and ei.value.ordinal == 2
    for j, t in pair.outcomes():
        assert t == j == ("InjectedFault", None, "engine.tick")
    assert pair.t.active_requests() == [] and pair.t.pool.pages_in_use == 0
    pair.futs.clear()
    pair.submit(_fault_prompt(cfg, seed=2), 3)
    pair.run()
    pair.check()


# ---------------------------------------------------------------------------
# Torn and corrupt checkpoints
# ---------------------------------------------------------------------------

def _port_state(model):
    return {k: v.detach().numpy().copy() for k, v in
            model.state_dict().items()}


@pytest.mark.parametrize("mode", ["torn", "corrupt", "all"])
def test_torn_checkpoint_falls_back(models, tmp_path, mode):
    """``tear_checkpoint`` damages the newest step of a port checkpoint as
    the reference's damages its own; both restores fall back to the older
    valid step (or find none when every step is damaged)."""
    _, params, _, model = models
    state = _port_state(model)
    steps = (1,) if mode == "all" else (1, 2)
    pdir, jdir = tmp_path / "port", tmp_path / "ref"
    pm, jm = CheckpointManager(str(pdir), keep=2), JCkpt(str(jdir), keep=2)
    for s in steps:
        shifted = {k: v + s for k, v in state.items()}
        pm.save(s, {"params": shifted})
        jm.save(s, {"params": params})
    assert load_latest(str(pdir), {"params": state})[0] == steps[-1]
    damaged = tear_checkpoint(str(pdir), "corrupt" if mode == "corrupt"
                              else "torn")
    jtear(str(jdir), "corrupt" if mode == "corrupt" else "torn")
    assert damaged.endswith(f"step_{steps[-1]:09d}")
    step, tree, _ = load_latest(str(pdir), {"params": state})
    jstep = jloader.restore_params(
        jreg.get(ARCH).with_(compute_dtype="float32"), str(jdir))[0]
    if mode == "all":
        assert step is None and tree is None and jstep is None
    else:
        assert step == jstep == 1
        for k, v in state.items():
            np.testing.assert_array_equal(tree["params"][k], v + 1)


def test_tear_checkpoint_validation(tmp_path):
    with pytest.raises(FileNotFoundError, match="no step_"):
        tear_checkpoint(str(tmp_path))
    (tmp_path / "step_000000001").mkdir()
    with pytest.raises(ValueError, match="unknown tear mode"):
        tear_checkpoint(str(tmp_path), mode="shred")


# ---------------------------------------------------------------------------
# The rest of the engine's surface
# ---------------------------------------------------------------------------

def test_set_params_copies_in_place(models):
    """``set_params`` copies an LM's (or a state dict's) weights into the
    live parameters, keeping their storage (the graphs read it there), and
    refuses while requests are live; served tokens follow the new
    weights."""
    jcfg, params, tcfg, model = models
    other = carried(ARCH, seed=5)
    eng = ServeEngine(tcfg, copy.deepcopy(model), slots=2, max_len=32,
                      device="cpu")
    ptrs = [p.data_ptr() for p in eng.model.parameters()]
    prompt = _fault_prompt(tcfg)
    fut = eng.submit(Request(prompt=prompt, max_new_tokens=4))
    with pytest.raises(RuntimeError, match="drain"):
        eng.set_params(other[3])
    eng.run_until_idle(max_ticks=MAX_TICKS)
    eng.set_params(other[3].state_dict())
    assert [p.data_ptr() for p in eng.model.parameters()] == ptrs
    fut = eng.submit(Request(prompt=prompt, max_new_tokens=4))
    jeng = JServeEngine(jcfg, other[1], slots=2, max_len=32)
    jfut = jeng.submit(JRequest(prompt=prompt, max_new_tokens=4))
    eng.run_until_idle(max_ticks=MAX_TICKS)
    jeng.run_until_idle(max_ticks=MAX_TICKS)
    assert fut.result(0).tokens == jfut.result(0).tokens


def test_drain_and_adopt_move_queued_requests(models):
    """Queued requests drained from one engine and adopted by another
    (whole: futures, preempted tokens) finish there with the reference's
    tokens; ``outstanding`` counts queued plus in flight, and
    ``reset_metrics`` refuses under live requests."""
    _, _, tcfg, model = models
    pair = Pair(models, slots=1, max_len=64)
    rng = np.random.default_rng(6)
    for n in (5, 9, 7):
        pair.submit(_prompt(pair.cfg, n, rng), 4)
    pair.step()
    assert pair.t.outstanding() == 3
    with pytest.raises(RuntimeError, match="in flight"):
        pair.t.reset_metrics()
    moved = pair.t.drain_queued()
    assert len(moved) == 2 and pair.t.outstanding() == 1
    other = ServeEngine(tcfg, model, slots=1, max_len=64, device="cpu")
    for slot, record in moved:
        other.adopt(slot, record)
    pair.run()
    other.run_until_idle(max_ticks=MAX_TICKS)
    for j, t in pair.outcomes():
        assert t == j
    pair.t.reset_metrics()
    assert pair.t.metrics.snapshot()["ticks"] == 0

"""The port's tick driver and async client (`repro_torch.serve.client`) and
its heartbeat watchdog (`repro_torch.runtime.fault_tolerance`), on the
reference's cases (`tests/test_serve.py`, `tests/test_serve_faults.py`):

* a tick that raises fails every queued and in-flight future with the real
  error, and the client refuses further submissions;
* a tick that never returns trips the heartbeat: futures fail with
  `EngineWedged` and submissions are refused;
* a healthy driver never trips the watchdog; `tick_timeout` must be
  positive;
* futures resolve through the client with the reference client's greedy
  tokens, on the reference's weights carried into the port.

Every `result()` has a timeout and every client is closed in `finally`
(or a `with`)."""

import threading

import numpy as np
import pytest

from repro_torch.configs import registry as treg
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.serve import (EngineWedged, FaultInjector, InjectedFault,
                               Request, RequestCancelled, ServeClient,
                               ServeEngine, TickDriver, loader)

ARCH = "smollm-135m-smoke"
TIMEOUT = 60


@pytest.fixture(scope="module")
def model():
    return loader.init_params(treg.get(ARCH), seed=0, device="cpu")


def _engine(model, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_chunk", 4)
    return ServeEngine(treg.get(ARCH), model, seed=0, device="cpu", **kw)


def _prompt(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, treg.get(ARCH).vocab_size, n).astype(np.int32)


def test_injected_crash_fails_futures_and_refuses_submits(model):
    eng = _engine(model, faults=FaultInjector(at={"engine.tick": (1,)}))
    with ServeClient(eng) as client:
        fut = client.submit(Request(prompt=_prompt(), max_new_tokens=4))
        with pytest.raises(InjectedFault) as ei:
            fut.result(timeout=TIMEOUT)
        assert ei.value.site == "engine.tick"
        # the driver stopped before it swept the futures: refused at once
        with pytest.raises(RuntimeError, match="closed"):
            client.submit(Request(prompt=_prompt()))
    assert eng.active_requests() == []


def test_raising_step_fails_every_future_with_the_real_error(model):
    eng = _engine(model, slots=1)

    def boom():
        raise RuntimeError("tick exploded")
    eng.step = boom
    with ServeClient(eng) as client:
        futs = [client.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
                for _ in range(2)]
        for fut in futs:
            with pytest.raises(RuntimeError, match="tick exploded"):
                fut.result(timeout=TIMEOUT)
        with pytest.raises(RuntimeError, match="closed"):
            client.submit(Request(prompt=[1], max_new_tokens=1))
    assert not eng.metrics.requests        # aborted records were evicted
    assert eng.pool.pages_in_use == 0


def test_heartbeat_surfaces_wedged_tick(model):
    eng = _engine(model)
    release = threading.Event()
    real_step = eng.step

    def wedged_step():
        release.wait(timeout=30)           # a hung device call
        return real_step()

    client = ServeClient(eng, tick_timeout=0.3)
    try:
        eng.step = wedged_step
        fut = client.submit(Request(prompt=_prompt(), max_new_tokens=4))
        with pytest.raises(EngineWedged):
            fut.result(timeout=30)
        assert client.wedged
        with pytest.raises(RuntimeError, match="wedged"):
            client.submit(Request(prompt=_prompt()))
    finally:
        release.set()
        eng.step = real_step
        client.close()


def test_healthy_driver_never_trips_watchdog(model):
    eng = _engine(model)
    with ServeClient(eng, tick_timeout=30.0) as client:
        fut = client.submit(Request(prompt=_prompt(), max_new_tokens=4))
        assert len(fut.result(timeout=TIMEOUT).tokens) == 4
        assert not client.wedged


@pytest.mark.parametrize("bad", [0.0, -1.0])
def test_tick_timeout_validation(model, bad):
    eng = _engine(model)
    with pytest.raises(ValueError, match="tick_timeout"):
        ServeClient(eng, tick_timeout=bad)
    with pytest.raises(ValueError, match="tick_timeout"):
        TickDriver(eng, tick_timeout=bad)


def test_client_cancel_resolves_the_future(model):
    eng = _engine(model, slots=1)
    with ServeClient(eng) as client:
        futs = [client.submit(Request(prompt=_prompt(seed=i),
                                      max_new_tokens=12)) for i in range(3)]
        assert client.cancel(2)
        with pytest.raises(RequestCancelled):
            futs[2].result(timeout=TIMEOUT)
        assert [len(f.result(timeout=TIMEOUT).tokens) for f in futs[:2]] \
            == [12, 12]
        assert not client.cancel(2)


def test_client_tokens_match_reference_client():
    from repro.serve import Request as JRequest
    from repro.serve import ServeClient as JServeClient
    from repro.serve import ServeEngine as JServeEngine
    from test_torch_serve_lifecycle import carried
    jcfg, params, tcfg, model = carried(ARCH)
    prompts = [_prompt(n, seed=n) for n in (5, 9, 3)]
    kw = dict(slots=2, max_len=32, page_size=8, prefill_chunk=4, seed=0)
    with JServeClient(JServeEngine(jcfg, params, **kw)) as jc:
        want = [f.result(timeout=300).tokens for f in
                [jc.submit(JRequest(prompt=p, max_new_tokens=6))
                 for p in prompts]]
    eng = ServeEngine(tcfg, model, device="cpu", **kw)
    with ServeClient(eng) as client:
        got = [f.result(timeout=TIMEOUT).tokens for f in
               [client.submit(Request(prompt=p, max_new_tokens=6))
                for p in prompts]]
    assert got == want
    assert eng.metrics.snapshot()["requests_finished"] == 3


def test_heartbeat_monitor_marks_silent_worker_dead_once():
    fired = []
    done = threading.Event()

    def on_failure(w):
        fired.append(w)
        done.set()

    with HeartbeatMonitor(["a", "b"], timeout=0.2, on_failure=on_failure,
                          poll=0.01) as hb:
        stop = threading.Event()

        def pinger():
            while not stop.is_set():
                hb.ping("a")
                stop.wait(0.02)
        t = threading.Thread(target=pinger, daemon=True)
        t.start()
        try:
            assert done.wait(timeout=10)
            assert hb.dead == ["b"] and hb.alive == ["a"]
            hb.ping("b")                   # a dead worker stays dead
            assert hb.dead == ["b"]
        finally:
            stop.set()
            t.join(timeout=5)
        assert not t.is_alive()
    assert fired == ["b"]

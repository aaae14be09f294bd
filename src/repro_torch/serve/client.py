"""The tick driver + in-process async client.

The port's copy of ``repro.serve.client``, with the same contract.

The engine's tick loop is single-threaded by contract; :class:`TickDriver`
owns that thread. It drives any *tickable* — an object with
``has_work() -> bool``, ``step()``, and ``abort_all(exc)`` — which is a
:class:`~repro_torch.serve.engine.ServeEngine` for the single-engine
:class:`ServeClient`, and a :class:`repro_torch.serve.router.Router` (whose one
``step()`` round-robins a tick over every replica) for the multi-replica
tier: ONE thread multiplexes all replicas, so router scheduling stays as
deterministic and CPU-testable as the engine itself.

The driver loop: ping the heartbeat, ``step()`` while work exists, park on
a wake event when the target drains — no busy-polling between bursts. A
``step()`` that *raises* stops the driver and fails every outstanding
future with the real error via ``abort_all`` (no stranded futures on a
dead daemon thread); a ``step()`` that never *returns* is caught by the
heartbeat watchdog (``tick_timeout``) and surfaces as
:class:`EngineWedged`.

    with ServeClient(engine) as client:
        futs = [client.submit(Request(prompt=p, max_new_tokens=16))
                for p in prompts]
        results = [f.result(timeout=60) for f in futs]

Liveness: with ``tick_timeout`` set, a :class:`repro_torch.runtime.
fault_tolerance.HeartbeatMonitor` watches the driver thread — every loop
iteration pings it, so a *wedged tick* (``step()`` stuck in a hung device
call) goes silent and the watchdog fires within ``tick_timeout`` seconds:
outstanding futures fail with :class:`EngineWedged` instead of hanging
until their ``result()`` timeouts, and further submissions are refused.
Detection, not recovery — the wedged thread itself cannot be killed from
Python; the point is that callers *find out*.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import Future
from typing import Optional

from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.serve.engine import Request, ServeEngine

#: the heartbeat worker name the driver thread pings
_DRIVER = "serve-driver"


class EngineWedged(RuntimeError):
    """The driver thread stopped ticking (a hung ``step()``): the
    heartbeat watchdog failed all outstanding futures and closed the
    driver to new submissions. Distinct from a tick that *raises* (futures
    get the real exception) — this is the tick that never returns."""

    def __init__(self, timeout: float):
        super().__init__(
            f"serve driver thread missed its heartbeat for more than "
            f"{timeout:.3f}s — a tick is wedged; outstanding requests "
            f"were failed and the client is closed")
        self.timeout = timeout


class TickDriver:
    """One daemon thread driving a tickable's ``step()`` loop.

    ``target`` needs three methods: ``has_work()`` (anything queued or in
    flight?), ``step()`` (advance one tick — for a router, one round-robin
    pass over its replicas), and ``abort_all(exc)`` (fail every
    outstanding future). ``tick_timeout`` (seconds, ``None`` = no
    watchdog) bounds one *loop iteration* — a tick plus the idle park
    (50 ms) — so set it comfortably above the slowest expected tick
    (build ticks included), not above the whole request latency.

    On a card the slowest ticks are the first ones: a kernel library not
    yet built compiles at its first call (nvcc, 10–45 s a library), and a
    graph key's first tick runs its warm-up and capture (0.05–0.3 s at
    full width). Build the libraries before the driver starts
    (``kernels.build``, as ``launch/serve.py`` does), or set
    ``tick_timeout`` above the build, or a healthy engine trips
    :class:`EngineWedged`. A router's loop iteration is one tick of every
    replica.

    Whoever enqueues work onto the target must do it inside
    :meth:`submit_scope` (which raises once the driver stopped) and then
    :meth:`wake` the thread — that ordering is what guarantees a submit
    racing :meth:`close` either lands before the post-exit sweep (and is
    failed by it) or observes the stop flag and raises, never leaving a
    silently stranded future.
    """

    def __init__(self, target, tick_timeout: Optional[float] = None,
                 name: str = "serve-engine"):
        self.target = target
        self.tick_timeout = tick_timeout
        self.wedged = False
        self._wake = threading.Event()
        self._stop = threading.Event()
        # serializes submit_scope's stop-check+enqueue against the
        # driver's post-exit sweep (see class docstring)
        self._lock = threading.Lock()
        self._hb: Optional[HeartbeatMonitor] = None
        if tick_timeout is not None:
            if tick_timeout <= 0:
                raise ValueError(f"tick_timeout must be positive or None, "
                                 f"got {tick_timeout}")
            self._hb = HeartbeatMonitor(
                [_DRIVER], timeout=tick_timeout,
                on_failure=self._on_wedged,
                poll=min(0.05, tick_timeout / 4))
        self._thread = threading.Thread(target=self._drive, name=name,
                                        daemon=True)
        self._thread.start()

    # -- public --------------------------------------------------------

    @contextlib.contextmanager
    def submit_scope(self):
        """Context for enqueueing work on the target: raises when the
        driver has stopped (wedged or closed), and serializes against the
        post-exit sweep so the enqueued future can never be stranded.
        Call :meth:`wake` after the scope exits."""
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError(
                    "client is wedged" if self.wedged else
                    "client is closed")
            yield

    def wake(self) -> None:
        self._wake.set()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def close(self, timeout: float = 60.0) -> None:
        """Stop the driver thread after the target drains its current
        work; idempotent."""
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout)
        if self._hb is not None:
            self._hb.close()

    # -- watchdog ------------------------------------------------------

    def _on_wedged(self, worker: str) -> None:
        """Heartbeat callback (watchdog thread): the driver went silent.

        Best-effort crash surfacing — the wedged thread may sit inside a
        hung tick holding partial slot state, so the target is NOT safe to
        reuse afterwards; what matters is that every outstanding future
        resolves with :class:`EngineWedged` instead of hanging, and that
        submits are refused."""
        self.wedged = True
        self._stop.set()
        self._wake.set()
        with self._lock:
            if self.target.has_work():
                self.target.abort_all(EngineWedged(self.tick_timeout))

    # -- driver --------------------------------------------------------

    def _drive(self) -> None:
        exc: BaseException = RuntimeError("client is closed")
        while True:
            if self._hb is not None:
                self._hb.ping(_DRIVER)
            if self._stop.is_set() and self.wedged:
                # watchdog declared us wedged while we were merely slow:
                # it already swept the futures; just exit
                return
            if self.target.has_work():
                try:
                    self.target.step()
                except BaseException as e:
                    # a dead driver must not strand futures: fail every
                    # queued/in-flight request with the real error and
                    # refuse further submissions (submit_scope raises once
                    # _stop is set)
                    self._stop.set()
                    exc = e
                    break
                continue
            if self._stop.is_set():
                break
            self._wake.wait(timeout=0.05)
            self._wake.clear()
        # post-exit sweep, serialized against submit_scope: anything that
        # raced its way into the queue after our last has_work() look
        # resolves with an error instead of hanging until a result()
        # timeout
        with self._lock:
            if self.target.has_work():
                self.target.abort_all(exc)


class ServeClient:
    """Async facade over a :class:`ServeEngine` (one driver thread).

    ``submit() -> Future`` over a :class:`TickDriver` that owns the
    engine's tick loop; futures resolve to
    :class:`~repro_torch.serve.engine.GenerationResult` as requests finish, in
    completion (not submission) order — which is the whole point of
    continuous batching. ``tick_timeout`` arms the driver's heartbeat
    watchdog (see :class:`TickDriver`).
    """

    def __init__(self, engine: ServeEngine,
                 tick_timeout: Optional[float] = None):
        self.engine = engine
        self.tick_timeout = tick_timeout
        self._driver = TickDriver(engine, tick_timeout=tick_timeout)

    # -- public --------------------------------------------------------

    @property
    def wedged(self) -> bool:
        return self._driver.wedged

    def submit(self, request: Request) -> Future:
        """Queue a :class:`repro_torch.serve.Request`; the engine raises
        ``TypeError`` for anything else."""
        with self._driver.submit_scope():
            fut = self.engine.submit(request)
        self._driver.wake()
        return fut

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or in-flight request by rid (thread-safe).

        Returns whether the engine currently knows the rid; when it does,
        the request's future resolves with
        :class:`~repro_torch.serve.engine.RequestCancelled` at the next tick
        boundary and its slot + pages free immediately there."""
        known = self.engine.cancel(rid)
        if known:
            self._driver.wake()
        return known

    def close(self, timeout: float = 60.0) -> None:
        """Stop the driver thread after the engine drains its current
        work; idempotent."""
        self._driver.close(timeout=timeout)

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

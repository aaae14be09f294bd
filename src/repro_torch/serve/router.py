"""Multi-replica serving tier: one front door over N engine replicas.

The port's copy of ``repro.serve.router``, with the same dispatch, drain,
hot-swap and death semantics. A :class:`Router` dispatches frozen
:class:`~repro_torch.serve.Request`\\ s across in-process engine
replicas. One :class:`~repro_torch.serve.client.TickDriver` thread drives
:meth:`Router.step`, which round-robins a tick over every replica, so
the whole tier stays single-driver deterministic: tests drive
``step()``/``run_until_idle()`` synchronously, production wraps the
router in its driver via ``with router: ...``.

**Dispatch** is weighted least-outstanding-requests over the health
signals the engines already emit: each live replica is scored
``(outstanding + page_pressure) / weight`` — ``outstanding`` is queued +
in-flight requests, ``page_pressure`` is the pool's
``pages_in_use / total_pages`` gauge (a tie-break nudge away from
memory-pressured replicas), ``weight`` the replica's static capacity
multiplier — and the submit goes to the lowest score (ties to the lowest
index). Backpressure is *typed*: a replica shedding with
:class:`~repro_torch.serve.QueueFull` fails over to the next-best replica; only
when EVERY live replica sheds does the router re-raise ``QueueFull`` to
the caller (tier-level load shedding, counted in the snapshot).
``PoolExhausted`` never reaches the router — it is the engine-internal
defer/preempt signal — but its pressure shows up in the score.

**Drain / hot-swap** (`drain` → `wait_drained` → `set_params` →
`undrain`, packaged as :meth:`swap_checkpoint`): draining a replica stops
new dispatch to it, *requeues* its not-yet-admitted requests onto the
other replicas (the internal slot travels whole — Request, Future, and
preemption-recompute state — so nothing is dropped and wall-clock
TTFT/latency still span from the original submit), and lets in-flight
requests *finish* in place. Once drained, the newest *valid* checkpoint
swaps in (torn/corrupt ones fall back via the loader — tear one with
:func:`repro_torch.serve.faults.tear_checkpoint` to drill it) while the
other replicas keep serving; greedy outputs across a swap are
token-identical to a no-swap run. With no other live replica, a drain
degrades to finish-everything: queued work stays put rather than being
dropped. A swap copies weights into the replica's live parameters and
keeps its truncation-index buffers (:meth:`ServeEngine.set_params`).

**On one card** the replicas share the device. Each replica keeps its own
graph cache and graph pool; a capture does not fail because another
thread copies a checkpoint in meanwhile (captures are thread-local, and
``set_params`` holds the engine's tick lock). The kernels' launch
counters are process-wide, so they sum over every replica.

**Replica death**: a replica whose tick *raises* (device error, injected
fault) is marked dead and routed around — its in-flight futures fail
with the real error, its queued requests requeue onto live replicas, and
dispatch never selects it again. The tier keeps serving as long as one
replica lives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.tracing import TRACK_ENGINE
from repro_torch.serve.client import TickDriver
from repro_torch.serve.engine import QueueFull, Request, ServeEngine
from repro_torch.serve.loader import restore_params
from repro_torch.serve.metrics import _percentile


@dataclass
class _Replica:
    """Router-side state of one engine replica."""

    engine: ServeEngine
    weight: float = 1.0
    draining: bool = False
    dead: Optional[BaseException] = None
    dispatched: int = 0              # submits routed here
    shed: int = 0                    # QueueFull failovers away from here

    @property
    def live(self) -> bool:
        """Eligible for new dispatch."""
        return self.dead is None and not self.draining


class Router:
    """Weighted least-outstanding-requests dispatch over engine replicas.

    * ``engines`` — the replicas; geometry must be uniform (same arch and
      ``max_len``, checked here) so any request — including a preempted
      one mid-recompute — can be requeued onto any replica. Each holds
      its own model: a swap copies weights in place, so two replicas
      sharing one would swap together.
    * ``weights`` — optional per-replica capacity multipliers (default
      all 1.0): a replica with weight 2 absorbs twice the outstanding
      load before losing a tie.
    * ``tick_timeout`` — heartbeat watchdog bound for the driver thread
      (see :class:`~repro_torch.serve.client.TickDriver`), armed by
      :meth:`start` / ``with router:``.

    The router is created *passive*: drive it synchronously with
    :meth:`step` / :meth:`run_until_idle` (deterministic tests), or call
    :meth:`start` (or enter the context manager) to attach the one
    driver thread. ``submit()`` is thread-safe either way.

    Observability: ``tracer``/``registry`` default to replica 0's, so a
    tier built over engines sharing one :class:`repro_torch.obs.Tracer`
    and one :class:`repro_torch.obs.MetricsRegistry` gets router lifecycle
    events
    (``drain``/``undrain``/``swap_checkpoint``/``replica_dead`` on the
    target replica's engine lane) and the tier counters
    (``router_*`` callbacks) on the same unified surface.
    """

    def __init__(self, engines: Sequence[ServeEngine], *,
                 weights: Optional[Sequence[float]] = None,
                 tick_timeout: Optional[float] = None,
                 tracer=None, registry=None):
        engines = list(engines)
        if not engines:
            raise ValueError("need at least one engine replica")
        if len(set(map(id, engines))) != len(engines):
            raise ValueError("replicas must be distinct engines")
        if len({id(e.model) for e in engines}) != len(engines):
            raise ValueError("replicas must hold distinct models: a swap "
                             "copies weights into the live parameters")
        names = {e.cfg.name for e in engines}
        lens = {e.max_len for e in engines}
        if len(names) > 1 or len(lens) > 1:
            raise ValueError(
                f"replica geometry must be uniform so requests can "
                f"requeue across replicas: got archs {sorted(names)}, "
                f"max_len {sorted(lens)}")
        if weights is None:
            weights = [1.0] * len(engines)
        if len(weights) != len(engines):
            raise ValueError(f"{len(weights)} weights for "
                             f"{len(engines)} engines")
        if any(w <= 0 for w in weights):
            raise ValueError(f"weights must be positive, got {weights}")
        self.replicas = [_Replica(engine=e, weight=float(w))
                         for e, w in zip(engines, weights)]
        self.tick_timeout = tick_timeout
        self._driver: Optional[TickDriver] = None
        # one lock for dispatch bookkeeping (owner map, counters); the
        # engines have their own locks and the driver its own
        self._lock = threading.Lock()
        self._next_rid = 0
        self._owner: Dict[int, int] = {}       # rid -> replica index
        # tier-level counters (all mutated under self._lock)
        self.requeued = 0                      # drain/death queue moves
        self.shed = 0                          # QueueFull from EVERY replica
        self.drains = 0
        self.swaps = 0
        self.passes = 0                        # step() calls that found work
        self.max_concurrent = 0                # aggregate occupied-slot HWM
        self.tracer = tracer if tracer is not None else engines[0].tracer
        self.obs = registry if registry is not None else engines[0].obs
        self._register_obs()

    def _register_obs(self) -> None:
        """Tier-level callbacks into the shared registry (newest wins on
        re-register, so rebuilding a router over the same registry is
        fine)."""
        reg = self.obs

        def cb(name, fn, mtype, help):
            reg.register_callback(name, fn, mtype=mtype, help=help)

        cb("router_requeued_total", lambda: self.requeued, "counter",
           "queued requests moved across replicas (drain/death)")
        cb("router_shed_total", lambda: self.shed, "counter",
           "submits shed by EVERY live replica (tier-level QueueFull)")
        cb("router_drains_total", lambda: self.drains, "counter",
           "replica drains initiated")
        cb("router_swaps_total", lambda: self.swaps, "counter",
           "checkpoint hot-swaps completed")
        cb("router_passes_total", lambda: self.passes, "counter",
           "round-robin passes that found work")
        cb("router_max_concurrent_slots", lambda: self.max_concurrent,
           "gauge", "aggregate occupied-slot high-water mark")
        cb("router_replicas", lambda: len(self.replicas), "gauge",
           "configured replicas")
        cb("router_replicas_live",
           lambda: sum(r.live for r in self.replicas), "gauge",
           "replicas eligible for dispatch (not dead, not draining)")

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "Router":
        """Attach the one driver thread (idempotent; a closed router
        stays closed — make a new one rather than resurrecting a tier
        whose replicas may hold swept state)."""
        if self._driver is not None and self._driver.stopped:
            raise RuntimeError("router was closed; build a new Router")
        if self._driver is None:
            self._driver = TickDriver(self, tick_timeout=self.tick_timeout,
                                      name="serve-router")
        return self

    def close(self, timeout: float = 60.0) -> None:
        """Stop the driver after the tier drains its current work;
        idempotent. Further submits raise (the driver reference is kept
        so `submit_scope` can refuse them)."""
        if self._driver is not None:
            self._driver.close(timeout=timeout)

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- client surface -------------------------------------------------

    def submit(self, request: Request) -> Future:
        """Dispatch to the lowest-scored live replica; fail over on
        :class:`QueueFull`; re-raise it only when every live replica
        sheds. Thread-safe. Raises ``RuntimeError`` when no replica is
        live (all dead or draining)."""
        scope = (self._driver.submit_scope() if self._driver is not None
                 else contextlib.nullcontext())
        with scope:
            fut = self._dispatch(request)
        if self._driver is not None:
            self._driver.wake()
        return fut

    def _dispatch(self, request: Request) -> Future:
        with self._lock:
            if request.rid is None:
                request = dataclasses.replace(request, rid=self._next_rid)
            rid = int(request.rid)
            if rid in self._owner:
                raise ValueError(f"rid {rid} is already in flight on "
                                 f"replica {self._owner[rid]}")
            self._next_rid = max(self._next_rid, rid) + 1
        ranked = self._ranked(exclude=None)
        if not ranked:
            raise RuntimeError(
                "no live replica: every replica is dead or draining")
        last: Optional[QueueFull] = None
        for i in ranked:
            r = self.replicas[i]
            try:
                fut = r.engine.submit(request)
            except QueueFull as e:
                with self._lock:
                    r.shed += 1
                last = e
                continue
            with self._lock:
                r.dispatched += 1
                self._owner[rid] = i
            fut.add_done_callback(
                lambda _f, rid=rid: self._forget(rid))
            return fut
        with self._lock:
            self.shed += 1
        raise last

    def cancel(self, rid: int) -> bool:
        """Cancel wherever the request currently lives (it may have been
        requeued across replicas since submit). Thread-safe."""
        with self._lock:
            i = self._owner.get(rid)
        order = ([i] if i is not None else []) + [
            j for j in range(len(self.replicas)) if j != i]
        for j in order:
            if self.replicas[j].engine.cancel(rid):
                if self._driver is not None:
                    self._driver.wake()
                return True
        return False

    def _forget(self, rid: int) -> None:
        with self._lock:
            self._owner.pop(rid, None)

    # -- dispatch policy ------------------------------------------------

    def _score(self, r: _Replica) -> float:
        total = r.engine.pool.total_pages
        pressure = (r.engine.pool.pages_in_use / total) if total else 0.0
        return (r.engine.outstanding() + pressure) / r.weight

    def _ranked(self, exclude: Optional[int]) -> List[int]:
        """Live replica indices, best dispatch candidate first
        (deterministic: score, then index)."""
        cands = [(self._score(r), i)
                 for i, r in enumerate(self.replicas)
                 if r.live and i != exclude]
        return [i for _, i in sorted(cands)]

    def outstanding(self, i: Optional[int] = None) -> int:
        if i is not None:
            return self.replicas[i].engine.outstanding()
        return sum(r.engine.outstanding() for r in self.replicas)

    # -- drain / hot-swap ----------------------------------------------

    def drain(self, i: int) -> None:
        """Stop dispatching to replica ``i``; its queued requests requeue
        onto the other live replicas at the next driver pass and its
        in-flight requests finish in place. Idempotent; undo with
        :meth:`undrain`."""
        r = self.replicas[i]
        with self._lock:
            if not r.draining:
                r.draining = True
                self.drains += 1
                self.tracer.instant("drain", pid=r.engine.replica,
                                    tid=TRACK_ENGINE, replica=i)
        if self._driver is not None:
            self._driver.wake()

    def undrain(self, i: int) -> None:
        """Return replica ``i`` to the dispatch rotation."""
        with self._lock:
            if self.replicas[i].draining:
                self.tracer.instant(
                    "undrain", pid=self.replicas[i].engine.replica,
                    tid=TRACK_ENGINE, replica=i)
            self.replicas[i].draining = False

    def drained(self, i: int) -> bool:
        """Is replica ``i`` draining AND empty (nothing queued or in
        flight)?"""
        r = self.replicas[i]
        return r.draining and not r.engine.has_work()

    def wait_drained(self, i: int, timeout: float = 300.0) -> None:
        """Block until replica ``i`` is drained. With a driver attached
        this just waits; without one it drives :meth:`step` itself, so
        synchronous tests need no thread."""
        if not self.replicas[i].draining:
            raise RuntimeError(f"replica {i} is not draining — call "
                               f"drain({i}) first")
        deadline = time.monotonic() + timeout
        while not self.drained(i):
            if self._driver is None:
                self.step()
            else:
                time.sleep(0.005)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replica {i} did not drain within {timeout}s "
                    f"(outstanding={self.outstanding(i)})")

    def swap_checkpoint(self, i: int, checkpoint_dir: str, *,
                        timeout: float = 300.0) -> int:
        """Checkpoint hot-swap on replica ``i`` while the others serve:
        drain it, restore the newest *valid* checkpoint under
        ``checkpoint_dir`` (torn/corrupt steps fall back to older valid
        ones), swap the params in, return the replica to rotation.
        Returns the restored step. The replica is undrained even when
        the restore fails — it still holds its old, consistent params."""
        r = self.replicas[i]
        tt0 = self.tracer.now()
        self.drain(i)
        try:
            self.wait_drained(i, timeout=timeout)
            step, params = restore_params(r.engine.cfg, checkpoint_dir)
            if params is None:
                raise FileNotFoundError(
                    f"no restorable checkpoint under {checkpoint_dir!r} "
                    f"(every candidate torn, corrupt, or absent)")
            r.engine.set_params(params)
            with self._lock:
                self.swaps += 1
            self.tracer.complete("swap_checkpoint", tt0, self.tracer.now(),
                                 pid=r.engine.replica, tid=TRACK_ENGINE,
                                 replica=i, step=int(step))
        finally:
            self.undrain(i)
        return step

    # -- the tick loop (TickDriver's tickable surface) -------------------

    def has_work(self) -> bool:
        return any(r.dead is None and r.engine.has_work()
                   for r in self.replicas)

    def step(self) -> int:
        """One round-robin pass: requeue off draining replicas, then tick
        every replica that has work (one engine tick each). Returns the
        aggregate number of occupied slots after the pass. Single-driver
        contract: call from one thread only (the TickDriver's, or the
        test's)."""
        self._process_drains()
        worked = False
        for i, r in enumerate(self.replicas):
            if r.dead is not None or not r.engine.has_work():
                continue
            worked = True
            try:
                r.engine.step()
            except BaseException as e:
                self._on_replica_error(i, e)
        occupied = sum(r.engine.occupied_slots() for r in self.replicas
                       if r.dead is None)
        with self._lock:
            if worked:
                self.passes += 1
            self.max_concurrent = max(self.max_concurrent, occupied)
        return occupied

    def run_until_idle(self, max_passes: int = 100_000) -> int:
        """Drive passes until every replica drains; returns passes spent
        (the tier's deterministic clock, as engine ticks are per
        replica)."""
        start = self.passes
        while self.has_work():
            self.step()
            if self.passes - start > max_passes:
                raise RuntimeError(
                    f"router did not drain within {max_passes} passes "
                    f"(outstanding={self.outstanding()})")
        return self.passes - start

    def abort_all(self, exc: BaseException) -> None:
        """Fail every queued and in-flight request on every replica (the
        driver's crash/wedge sweep)."""
        for r in self.replicas:
            if r.engine.has_work():
                r.engine.abort_all(exc)
        with self._lock:
            self._owner.clear()

    # -- internals ------------------------------------------------------

    def _process_drains(self) -> None:
        """Requeue queued requests off draining replicas onto live ones
        (driver thread). With no live replica to take them, they stay —
        the drain degrades to finish-everything rather than dropping
        accepted work."""
        for i, r in enumerate(self.replicas):
            if not r.draining or r.dead is not None:
                continue
            if r.engine.queued() == 0 or not self._ranked(exclude=i):
                continue
            for slot, record in r.engine.drain_queued():
                self._requeue(i, slot, record)

    def _requeue(self, src: int, slot, record) -> bool:
        """Adopt a drained slot onto the best live replica (never sheds:
        the tier already accepted this request). Returns whether a new
        home was found; otherwise the slot goes back to the head of the
        source replica's queue."""
        ranked = self._ranked(exclude=src)
        if ranked:
            j = ranked[0]
            self.replicas[j].engine.adopt(slot, record)
            with self._lock:
                self._owner[slot.rid] = j
                self.requeued += 1
            return True
        self.replicas[src].engine.adopt(slot, record, front=True)
        return False

    def _on_replica_error(self, i: int, exc: BaseException) -> None:
        """A replica's tick raised: mark it dead, requeue its queued
        requests onto live replicas (or fail them when none exists), fail
        its in-flight futures with the real error, and route around it
        from now on."""
        r = self.replicas[i]
        with self._lock:
            r.dead = exc
        self.tracer.instant("replica_dead", pid=r.engine.replica,
                            tid=TRACK_ENGINE, replica=i, error=repr(exc))
        stolen = r.engine.drain_queued()
        r.engine.abort_all(exc)          # fails in-flight futures
        for slot, record in stolen:
            ranked = self._ranked(exclude=i)
            if ranked:
                j = ranked[0]
                self.replicas[j].engine.adopt(slot, record)
                with self._lock:
                    self._owner[slot.rid] = j
                    self.requeued += 1
            elif not slot.future.done():
                slot.future.set_exception(exc)

    # -- reporting ------------------------------------------------------

    def snapshot(self) -> Dict:
        """JSON-able tier summary: aggregate SLO percentiles (TTFT and
        end-to-end latency over every replica's recent finished window),
        tier counters, and the per-replica engine snapshots."""
        done = []
        per = []
        with self._lock:
            counters = dict(requeued=self.requeued, shed=self.shed,
                            drains=self.drains, swaps=self.swaps,
                            passes=self.passes,
                            max_concurrent_slots=self.max_concurrent)
            states = [(r.dispatched, r.shed, r.weight, r.draining,
                       r.dead) for r in self.replicas]
        for r, (disp, shed, w, draining, dead) in zip(self.replicas,
                                                      states):
            done.extend(r.engine.metrics.finished())
            per.append({
                "dispatched": disp, "shed": shed, "weight": w,
                "draining": draining,
                "dead": repr(dead) if dead is not None else None,
                "engine": r.engine.metrics.snapshot(),
            })
        ttfts = sorted(rm.ttft for rm in done)
        lats = sorted(rm.latency for rm in done)
        return {
            "replicas": len(self.replicas),
            "requests_finished": len(done),
            **counters,
            "ttft_ms": {
                "p50": round(_percentile(ttfts, 0.50) * 1e3, 3),
                "p95": round(_percentile(ttfts, 0.95) * 1e3, 3),
            },
            "latency_ms": {
                "p50": round(_percentile(lats, 0.50) * 1e3, 3),
                "p95": round(_percentile(lats, 0.95) * 1e3, 3),
            },
            "per_replica": per,
        }

    def telemetry(self) -> Dict:
        """Unified telemetry doc: the tier ``snapshot()`` summary plus the
        shared registry's stable-schema metrics dump (same shape as
        :meth:`ServeEngine.telemetry`)."""
        return {
            "schema": "repro.serve/telemetry-1",
            "summary": self.snapshot(),
            "metrics": self.obs.snapshot(),
        }

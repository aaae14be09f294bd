"""Serving on a mesh, one process a rank: rank 0's control flow mirrored
to the other ranks.

The reference serves a mesh from one controller: one engine, one tick
loop, and XLA's partitioner spreads each tick over the devices. The port
runs one process a rank (:mod:`repro_torch.runtime.dist`), each with its
own :class:`~repro_torch.serve.engine.ServeEngine` (or
:class:`~repro_torch.serve.router.Router` of engines) over the same mesh,
and a tick's butterfly sites issue a gather on every rank
(:mod:`repro_torch.runtime.butterfly_sharding`). The ranks must therefore
take the same host decisions on every tick: a rank that admits, preempts
or finishes differently issues a gather the others never match, and both
hang. This module makes them agree. It has no counterpart in the
reference, whose single controller needs none.

**Rank 0 owns the request stream.** Its :class:`MeshServe` takes the
client's calls (``submit``, ``cancel``, and on a router ``drain``,
``undrain`` and ``swap_checkpoint``), applies each to its own target at
once, under the lock its ticks hold, and logs it. Before each tick it
broadcasts, over a CPU gloo group of the mesh's ranks, the log since the
last tick (each event with the clock reading it was applied at, and the
outcome it had), the clock reading the tick's ``deadline_s`` pass is
judged against, and a digest of its state. Every other rank runs
:meth:`MeshServe.follow`: it applies the same events to its own target in
the same order, each under the same pinned clock reading, checks that it
met the same outcome and that its digest equals rank 0's, then steps with
rank 0's reading. A stop (:meth:`MeshServe.stop`) ends the followers.

What stays equal without being sent: admission, growth, preemption and
finishing follow from the same events applied to the same state; the
router dispatches, requeues and routes around a dead replica by the same
scores, in one thread, in replica order; a seeded
:class:`~repro_torch.serve.faults.FaultInjector` fires at the same calls.
The sampled tokens are not sent: every rank computes the same logits bit
for bit (the sites' gathers give every rank the same rows; the rest runs
whole, the same kernels on the same inputs), which the CPU tests show
(``tests/test_torch_sharded_serve.py``). The digest (each engine's tick
count, queued rids, and each slot's rid, token count and last token)
catches a divergence at the next tick and fails the follower with both
states; rank 0 then fails at its next collective, after the group's
``timeout``. So a divergence fails, it does not hang.

The clock: a :class:`MirroredClock` is every engine's clock on every
rank. It reads ``time.monotonic()`` unless a reading is pinned, which the
mirror does while an event is applied; so a request's ``submit_t`` is
rank 0's reading on every rank, and ``deadline_s`` is judged against the
tick's broadcast reading. Only those readings decide control flow; the
other metric times (admission, first token, finish) stay each rank's own.

Usage, in every rank of the world that holds the mesh::

    engine = ServeEngine(cfg, model, ..., context=ExecutionContext(
        mesh_shape=(2,)))
    mirror = MeshServe(engine)
    if mirror.leader:
        with mirror:                     # a driver thread, as ServeClient
            fut = mirror.submit(Request(prompt=..., max_new_tokens=16))
            fut.result()
    else:
        mirror.follow()                  # until rank 0 stops

A passive leader is driven by hand (``step``, ``run_until_idle``, then
``stop``). On a mesh of one rank, or without a mesh, the mirror sends
nothing and :meth:`follow` returns at once.
"""

from __future__ import annotations

import contextlib
import datetime
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import torch.distributed as dist

from repro_torch.runtime import dist as rdist
from repro_torch.serve.client import TickDriver
from repro_torch.serve.router import Router

__all__ = ["MeshDiverged", "MeshServe", "MirroredClock"]


class MeshDiverged(RuntimeError):
    """A follower's state or an event's outcome differs from rank 0's."""


class MirroredClock:
    """``time.monotonic()``, or the reading pinned by :meth:`pinned`."""

    def __init__(self):
        self._pinned: Optional[float] = None

    def __call__(self) -> float:
        t = self._pinned
        return time.monotonic() if t is None else t

    @contextlib.contextmanager
    def pinned(self, t: float):
        self._pinned = float(t)
        try:
            yield
        finally:
            self._pinned = None


def _engines(target) -> List[Any]:
    return ([r.engine for r in target.replicas] if isinstance(target, Router)
            else [target])


def _outcome(exc: Optional[BaseException]) -> Optional[str]:
    return None if exc is None else type(exc).__name__


class MeshServe:
    """The mirror of one rank: rank 0 leads, every other rank of the mesh
    follows (module docstring).

    * ``target`` — this rank's :class:`ServeEngine` or :class:`Router`;
      its engines share one mesh and hold no request yet.
    * ``timeout`` — seconds a collective of the control group waits for a
      peer (``None``: torch's default, 30 minutes): a follower waits that
      long for rank 0's next tick.
    * ``tick_timeout`` — the leader's driver watchdog (:class:`TickDriver`).
    """

    def __init__(self, target, *, timeout: Optional[float] = None,
                 tick_timeout: Optional[float] = None):
        engines = _engines(target)
        meshes = {e.mesh_layout() for e in engines}
        if len(meshes) != 1:
            raise ValueError(f"the engines' meshes differ: {sorted(meshes)}")
        if any(e.outstanding() for e in engines):
            raise ValueError("MeshServe needs engines that hold no request "
                             "yet: every rank must start from one state")
        self.target = target
        self.engines = engines
        self.mesh = engines[0].mesh
        self.rank = rdist.rank()
        self.leader = self.rank == 0
        self.clock = MirroredClock()
        for e in engines:
            e.clock = e.metrics.clock = self.clock
        self.ranks = self.mesh.size if self.mesh is not None else 1
        self.group = None
        if self.ranks > 1:
            kw = {} if timeout is None else {
                "timeout": datetime.timedelta(seconds=timeout)}
            self.group = dist.new_group(ranks=list(range(self.ranks)),
                                        backend="gloo",
                                        use_local_synchronization=True,
                                        **kw)
        self.tick_timeout = tick_timeout
        self.ticks = 0                       # ticks stepped through here
        self.futures: List[Future] = []      # each accepted submit's future
        self.errors: List[BaseException] = []   # a follower's failed ticks
        self._log: List[Tuple] = []
        self._lock = threading.RLock()
        self._driver: Optional[TickDriver] = None
        self._stopped = False

    # -- the leader's client surface --------------------------------------

    def submit(self, request) -> Future:
        """Submit ``request`` to this rank's target and log it for the
        followers. Thread-safe; raises what the target raises."""
        scope = (self._driver.submit_scope() if self._driver is not None
                 else contextlib.nullcontext())
        with scope:
            fut = self._lead(("submit", request, time.monotonic()))
        if self._driver is not None:
            self._driver.wake()
        return fut

    def cancel(self, rid: int) -> bool:
        known = self._lead(("cancel", int(rid)))
        if known and self._driver is not None:
            self._driver.wake()
        return known

    def drain(self, i: int) -> None:
        """A router's :meth:`~repro_torch.serve.router.Router.drain`."""
        self._lead(("drain", int(i)))
        if self._driver is not None:
            self._driver.wake()

    def undrain(self, i: int) -> None:
        self._lead(("undrain", int(i)))

    def swap_checkpoint(self, i: int, checkpoint_dir: str, *,
                        timeout: float = 300.0) -> int:
        """A router's hot swap on a mesh: drain replica ``i``, wait until
        it is empty (driving ticks here when no driver is attached),
        restore the newest valid checkpoint under ``checkpoint_dir`` and
        copy it into the replica on every rank (the followers restore the
        same step), undrain. Returns the restored step."""
        from repro_torch.serve.loader import restore_params
        router = self.target
        if not isinstance(router, Router):
            raise TypeError("swap_checkpoint needs a Router target")
        self.drain(i)
        try:
            deadline = time.monotonic() + timeout
            while not router.drained(i):
                if self._driver is None:
                    self.step()
                else:
                    time.sleep(0.005)
                if time.monotonic() > deadline:
                    raise TimeoutError(f"replica {i} did not drain within "
                                       f"{timeout}s")
            step, params = restore_params(router.replicas[i].engine.cfg,
                                          checkpoint_dir)
            if params is None:
                raise FileNotFoundError(
                    f"no restorable checkpoint under {checkpoint_dir!r}")
            self._lead(("swap", int(i), checkpoint_dir, int(step)),
                       params=params)
        finally:
            self.undrain(i)
        return step

    def _lead(self, event: Tuple, params=None):
        """Apply ``event`` here and log it with its outcome."""
        if not self.leader:
            raise RuntimeError(f"rank {self.rank} follows rank 0: requests "
                               f"enter the mesh at rank 0")
        with self._lock:
            if self._stopped:
                raise RuntimeError("the mesh's serving was stopped")
            try:
                out = self._apply(event, params)
            except BaseException as exc:
                self._log.append((event, _outcome(exc)))
                raise
            self._log.append((event, None))
            return out

    # -- applying events (every rank) --------------------------------------

    def _apply(self, event: Tuple, params=None):
        kind, target = event[0], self.target
        if kind == "submit":
            with self.clock.pinned(event[2]):
                fut = target.submit(event[1])
            self.futures.append(fut)
            return fut
        if kind == "cancel":
            return target.cancel(event[1])
        if kind == "drain":
            return target.drain(event[1])
        if kind == "undrain":
            return target.undrain(event[1])
        if kind == "swap":
            _, i, path, step = event
            engine = target.replicas[i].engine
            if params is None:
                from repro_torch.serve.loader import restore_params
                got, params = restore_params(engine.cfg, path, step=step)
                if got != step:
                    raise MeshDiverged(f"rank {self.rank} restored step "
                                       f"{got} of {path!r}, rank 0 {step}")
            engine.set_params(params)
            with target._lock:
                target.swaps += 1
            return None
        if kind == "abort":
            return target.abort_all(RuntimeError(event[1]))
        raise ValueError(f"unknown mesh event {kind!r}")

    def digest(self) -> Tuple:
        """What every rank must agree on before a tick: per engine its
        tick count, its queued rids and each slot's (rid, tokens, last
        token); a router's dead and draining replicas."""
        out = []
        for e in self.engines:
            with e._lock:
                queued = tuple(s.rid for s in e._queue)
            slots = tuple(None if s is None else
                          (s.rid, len(s.tokens), s.last_token)
                          for s in e._slots)
            out.append((e.metrics.ticks, queued, slots))
        if isinstance(self.target, Router):
            out.append(tuple((r.dead is not None, r.draining)
                             for r in self.target.replicas))
        return tuple(out)

    # -- ticks -----------------------------------------------------------

    def has_work(self) -> bool:
        return self.target.has_work()

    def _send(self, payload: Dict) -> None:
        if self.group is not None:
            dist.broadcast_object_list([payload], src=0, group=self.group)

    def step(self) -> int:
        """The leader's tick: send the log, the tick's clock reading and
        the digest, then step the target with that reading."""
        if not self.leader:
            raise RuntimeError("followers step in follow()")
        with self._lock:
            if self._stopped:
                raise RuntimeError("the mesh's serving was stopped")
            now = time.monotonic()
            events, self._log = self._log, []
            self._send({"events": events, "now": now, "stop": False,
                        "digest": self.digest()})
            self.ticks += 1
            return self.target.step(now)

    def run_until_idle(self, max_ticks: int = 100_000) -> int:
        """Tick until the target drains (a passive leader); returns the
        ticks spent."""
        start = self.ticks
        while self.has_work():
            self.step()
            if self.ticks - start > max_ticks:
                raise RuntimeError(f"the mesh did not drain within "
                                   f"{max_ticks} ticks")
        return self.ticks - start

    def abort_all(self, exc: BaseException) -> None:
        """Fail every request here, and on the followers at the stop that
        follows (the driver's crash and wedge path)."""
        self.target.abort_all(exc)
        self._log.append((("abort", repr(exc)), None))

    def stop(self) -> None:
        """Send the remaining log and the stop; idempotent. Followers
        return from :meth:`follow`."""
        if not self.leader:
            return
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            events, self._log = self._log, []
            self._send({"events": events, "now": time.monotonic(),
                        "stop": True, "digest": self.digest()})

    def follow(self) -> int:
        """A follower's loop: receive rank 0's events and tick, apply them,
        check the digest, step; until the stop. Returns the ticks
        stepped. A tick that raises here is kept and the loop goes on:
        rank 0's tick raised at the same point and its abort follows."""
        if self.leader:
            raise RuntimeError("rank 0 leads; it does not follow")
        while self.group is not None:
            box: List[Any] = [None]
            dist.broadcast_object_list(box, src=0, group=self.group)
            payload = box[0]
            for event, want in payload["events"]:
                try:
                    self._apply(event)
                    got = None
                except BaseException as exc:
                    got = _outcome(exc)
                if got != want:
                    raise MeshDiverged(
                        f"rank {self.rank}: {event[0]} raised {got}, "
                        f"rank 0 {want} (None: no error)")
            mine = self.digest()
            if mine != payload["digest"]:
                raise MeshDiverged(
                    f"rank {self.rank} diverged from rank 0 before tick "
                    f"{self.ticks}: {mine} vs {payload['digest']}")
            if payload["stop"]:
                break
            self.ticks += 1
            try:
                self.target.step(payload["now"])
            except Exception as exc:    # rank 0's abort follows
                self.errors.append(exc)
        return self.ticks

    # -- an attached driver (the leader) -----------------------------------

    def start(self) -> "MeshServe":
        """Attach a driver thread that ticks while work exists (the
        leader)."""
        if not self.leader:
            raise RuntimeError("followers tick in follow()")
        if self._driver is None:
            self._driver = TickDriver(self, tick_timeout=self.tick_timeout,
                                      name="serve-mesh")
        return self

    def close(self, timeout: float = 60.0) -> None:
        """Stop the driver after the target drains, then stop the
        followers."""
        if self._driver is not None:
            self._driver.close(timeout=timeout)
        self.stop()

    def __enter__(self) -> "MeshServe":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

"""Bounded-ring span tracer with Chrome trace-event JSON export.

A copy of ``repro.obs.tracing`` for the port (stdlib only). The serving
tier emits spans through a :class:`Tracer` — per-request lifecycle spans
(``queue``, ``admit``, ``prefill_chunk[i]``, ``decode``, ``spec``,
``preempt``, ``finish`` …) and engine-level spans (``tick``,
``grow_pages``, ``compile``, ``swap_checkpoint``) — and exports them as
Chrome trace-event JSON that loads directly in Perfetto or
``chrome://tracing``.

Track layout: ``pid`` is the replica id (one process row per replica),
``tid`` 0 is the engine lane, and ``tid = rid + 1`` is the per-request
lane, so a request's whole timeline reads left-to-right on one row.
Events carry wall-clock timestamps (``ts``/``dur`` in microseconds since
the tracer's epoch, Chrome's native unit) *and*, where it applies, the
deterministic engine tick number in ``args["tick"]`` — wall time answers
"where did the latency go", the tick answers "was this run
deterministic".

Device time. On a CUDA device the engine's ticks are graph replays, which
return before the device is done; a span covers device time only where it
ends after a host read of the device's result. The port ends each span
where the reference does:

* ``decode`` (engine and request lanes) ends after the sampled tokens
  were read back, so it includes the decode tick's device time;
* ``tick`` contains the tick's reads (and, on a tick that only prefills,
  a wait for the device), so it includes all of the tick's device time;
  ``compile`` waits for the device after the warm-up and ends after the
  capture;
* ``prefill_chunk`` and ``prefill_chunk[i]``, ``spec_draft``,
  ``spec_verify`` and ``spec`` end right after their launches, before any
  read, so they cover the launch only; their device time lands in the
  next span that reads (the same tick's ``decode``, or the ``tick``);
* ``queue``, ``grow_pages`` and ``swap_checkpoint`` are host work.

Memory stays flat: the ring holds at most ``capacity`` events and counts
what it evicts in :attr:`Tracer.dropped`. The :data:`NULL_TRACER`
singleton is the default everywhere — every method is a no-op, so the
tracing-off hot path pays only a handful of no-op calls per engine tick.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "TRACK_ENGINE"]

#: tid of the engine lane inside each replica's process row. Request
#: lanes use ``rid + 1`` so they never collide with it.
TRACK_ENGINE = 0


class _Span:
    """Context manager emitting one complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_pid", "_tid", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, pid: int, tid: int,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._pid = pid
        self._tid = tid
        self._args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer.now()
        return self

    def __exit__(self, *exc) -> None:
        self._tracer.complete(self._name, self._t0, self._tracer.now(),
                              pid=self._pid, tid=self._tid, **self._args)


class _NullSpan:
    """Reusable, reentrant no-op context manager."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe bounded ring of Chrome trace events.

    Timestamps are microseconds since the tracer's construction
    (``time.perf_counter`` based); :meth:`now` hands them out and
    :meth:`complete` / :meth:`instant` record them. The ring drops the
    oldest event once ``capacity`` is reached (``dropped`` counts the
    evictions) so long-running servers never grow without bound.
    """

    enabled = True

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._events: deque = deque()
        self._epoch = time.perf_counter()
        self._process_names: Dict[int, str] = {}
        self._track_names: Dict[tuple, str] = {}
        self.dropped = 0
        self.emitted = 0

    # -- clock ---------------------------------------------------------
    def now(self) -> float:
        """Microseconds since this tracer's epoch (wall clock)."""
        return (time.perf_counter() - self._epoch) * 1e6

    # -- emission ------------------------------------------------------
    def _emit(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self.capacity:
                self._events.popleft()
                self.dropped += 1
            self._events.append(ev)
            self.emitted += 1

    def complete(self, name: str, t0: float, t1: float, *, pid: int = 0,
                 tid: int = TRACK_ENGINE, cat: str = "serve",
                 **args: Any) -> None:
        """Record a complete ("X") span covering ``[t0, t1]`` (µs)."""
        self._emit({
            "name": name, "cat": cat, "ph": "X",
            "ts": round(t0, 3), "dur": round(max(t1 - t0, 0.0), 3),
            "pid": int(pid), "tid": int(tid), "args": args,
        })

    def instant(self, name: str, *, pid: int = 0, tid: int = TRACK_ENGINE,
                cat: str = "serve", ts: Optional[float] = None,
                **args: Any) -> None:
        """Record an instant ("i") event (thread-scoped)."""
        t = self.now() if ts is None else ts
        self._emit({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": round(t, 3), "pid": int(pid), "tid": int(tid),
            "args": args,
        })

    def span(self, name: str, *, pid: int = 0, tid: int = TRACK_ENGINE,
             **args: Any) -> _Span:
        """Context manager recording a complete span around its body."""
        return _Span(self, name, pid, tid, args)

    # -- track naming --------------------------------------------------
    def name_process(self, pid: int, name: str) -> None:
        """Label a process row (one per replica) in the trace viewer."""
        with self._lock:
            self._process_names[int(pid)] = str(name)

    def name_track(self, pid: int, tid: int, name: str) -> None:
        """Label a thread row (engine lane / request lane)."""
        with self._lock:
            self._track_names[(int(pid), int(tid))] = str(name)

    # -- introspection / export ----------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> List[Dict[str, Any]]:
        """Copy of the ring contents (oldest first)."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        """Drop all buffered events and name maps; reset drop counters."""
        with self._lock:
            self._events.clear()
            self._process_names.clear()
            self._track_names.clear()
            self.dropped = 0
            self.emitted = 0

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event document: ``{"traceEvents": [...]}``.

        Track/process labels are synthesized as metadata ("M") events at
        export time, so naming a track is just a dict write on the hot
        path.
        """
        with self._lock:
            evs = list(self._events)
            pnames = dict(self._process_names)
            tnames = dict(self._track_names)
        meta: List[Dict[str, Any]] = []
        for pid, pname in sorted(pnames.items()):
            meta.append({"name": "process_name", "ph": "M", "ts": 0,
                         "pid": pid, "tid": 0, "args": {"name": pname}})
        for (pid, tid), tname in sorted(tnames.items()):
            meta.append({"name": "thread_name", "ph": "M", "ts": 0,
                         "pid": pid, "tid": tid, "args": {"name": tname}})
            # request lanes sort by rid, engine lane first
            meta.append({"name": "thread_sort_index", "ph": "M", "ts": 0,
                         "pid": pid, "tid": tid,
                         "args": {"sort_index": tid}})
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        return {"traceEvents": meta + evs, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        """Serialize :meth:`chrome_trace` to ``path`` as JSON."""
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)
            fh.write("\n")


class NullTracer(Tracer):
    """No-op tracer: every method returns immediately.

    Installed by default on every engine/router so the tracing-off hot
    path stays unmeasurably slow — no locks, no allocation, no clock
    reads. ``now()`` returns 0.0 (callers only ever feed it back into
    the no-op ``complete``).
    """

    enabled = False

    def __init__(self):
        super().__init__(capacity=1)

    def now(self) -> float:
        return 0.0

    def _emit(self, ev: Dict[str, Any]) -> None:
        return None

    def complete(self, name, t0, t1, *, pid=0, tid=TRACK_ENGINE,
                 cat="serve", **args) -> None:
        return None

    def instant(self, name, *, pid=0, tid=TRACK_ENGINE, cat="serve",
                ts=None, **args) -> None:
        return None

    def span(self, name, *, pid=0, tid=TRACK_ENGINE, **args) -> _NullSpan:
        return _NULL_SPAN

    def name_process(self, pid, name) -> None:
        return None

    def name_track(self, pid, tid, name) -> None:
        return None

    def clear(self) -> None:
        return None


#: Shared no-op singleton — the default ``tracer=`` everywhere.
NULL_TRACER = NullTracer()

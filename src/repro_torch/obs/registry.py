"""One lock-protected metrics registry for the whole process.

A copy of ``repro.obs.registry`` for the port (stdlib only).

Typed primitives — :class:`Counter` (monotone), :class:`Gauge`
(set/inc/dec), :class:`Histogram` (bucketed observations) — plus
*callback collectors* (a zero-arg function read at collection time) live
in a single :class:`MetricsRegistry`. The serving engine, router, cache
pool, fault injector, and graph cache all register into one registry,
so there is ONE machine-readable telemetry surface:

* :meth:`MetricsRegistry.snapshot` — a stable JSON document
  (``schema == SNAPSHOT_SCHEMA``) pinned by the golden-schema test.
* :meth:`MetricsRegistry.exposition` — Prometheus-style text, one
  ``# HELP`` / ``# TYPE`` header per metric family.

Callback collectors are the key to cheap instrumentation: the engine
registers ``lambda: self.metrics.preempted`` style closures that read
its live counters, so recording costs nothing extra on the hot path and
``engine.reset_metrics()`` (which swaps the ``EngineMetrics`` object)
is transparently reflected — the closure reads through ``self``.
Re-registering a callback under the same ``(name, labels)`` replaces the
old one (newest wins), so rebuilding an engine against a shared registry
does not error.

Everything here is stdlib-only and thread-safe: one registry ``RLock``
guards structure and every primitive's mutation.
"""

from __future__ import annotations

import bisect
import json
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "SNAPSHOT_SCHEMA", "DEFAULT_BUCKETS"]

#: Version tag stamped into every :meth:`MetricsRegistry.snapshot`.
SNAPSHOT_SCHEMA = "repro.obs/v1"

#: Default histogram buckets (seconds-flavoured, Prometheus-style).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0,
)

_TYPES = ("counter", "gauge", "histogram")


def _label_key(labels: Optional[Dict[str, Any]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Instantaneous value: set / inc / dec."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics).

    ``value`` renders as ``{"count", "sum", "buckets": {le: cumulative}}``
    with a final ``"+Inf"`` bucket equal to ``count``.
    """

    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, lock: threading.RLock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = lock
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last slot = +Inf overflow
        self._sum = 0.0
        self._count = 0

    @property
    def buckets(self) -> Tuple[float, ...]:
        return self._bounds

    def observe(self, v: float) -> None:
        with self._lock:
            self._counts[bisect.bisect_left(self._bounds, v)] += 1
            self._sum += v
            self._count += 1

    @property
    def value(self) -> Dict[str, Any]:
        with self._lock:
            cum: Dict[str, float] = {}
            running = 0
            for bound, c in zip(self._bounds, self._counts):
                running += c
                cum[repr(bound)] = running
            cum["+Inf"] = self._count
            return {"count": self._count, "sum": self._sum, "buckets": cum}


class MetricsRegistry:
    """Get-or-create registry of named, labelled metrics.

    A metric *family* is a name with a fixed type and help string; each
    distinct label set under it is one sample. Families are either
    primitive-backed (``counter()`` / ``gauge()`` / ``histogram()``
    hand out live objects) or callback-backed
    (``register_callback()`` — read lazily at collection time).
    Mixing the two under one ``(name, labels)`` key raises; so does
    re-declaring a name with a different type.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._types: Dict[str, str] = {}
        self._help: Dict[str, str] = {}
        self._prims: Dict[Tuple[str, tuple], Any] = {}
        self._callbacks: Dict[Tuple[str, tuple], Callable[[], Any]] = {}

    # -- declaration ---------------------------------------------------
    def _declare(self, name: str, mtype: str, help: str) -> None:
        if mtype not in _TYPES:
            raise ValueError(f"unknown metric type {mtype!r}")
        seen = self._types.get(name)
        if seen is not None and seen != mtype:
            raise ValueError(
                f"metric {name!r} already registered as {seen}, not {mtype}")
        self._types[name] = mtype
        if help and not self._help.get(name):
            self._help[name] = help

    def _primitive(self, name: str, mtype: str, help: str,
                   labels: Optional[Dict[str, Any]],
                   factory: Callable[[], Any], cls: type) -> Any:
        key = (name, _label_key(labels))
        with self._lock:
            self._declare(name, mtype, help)
            if key in self._callbacks:
                raise ValueError(
                    f"metric {name!r}{dict(key[1])} is callback-backed")
            prim = self._prims.get(key)
            if prim is None:
                prim = factory()
                self._prims[key] = prim
            elif not isinstance(prim, cls):
                raise ValueError(
                    f"metric {name!r}{dict(key[1])} is not a {cls.__name__}")
            return prim

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, Any]] = None) -> Counter:
        return self._primitive(name, "counter", help, labels,
                               lambda: Counter(self._lock), Counter)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, Any]] = None) -> Gauge:
        return self._primitive(name, "gauge", help, labels,
                               lambda: Gauge(self._lock), Gauge)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, Any]] = None,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._primitive(name, "histogram", help, labels,
                               lambda: Histogram(self._lock, buckets),
                               Histogram)

    def register_callback(self, name: str, fn: Callable[[], Any], *,
                          mtype: str = "gauge", help: str = "",
                          labels: Optional[Dict[str, Any]] = None) -> None:
        """Register a lazily-read collector. Newest wins on re-register."""
        key = (name, _label_key(labels))
        with self._lock:
            self._declare(name, mtype, help)
            if key in self._prims:
                raise ValueError(
                    f"metric {name!r}{dict(key[1])} is primitive-backed")
            self._callbacks[key] = fn

    # -- collection ----------------------------------------------------
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._types)

    def _collect(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            out: Dict[str, Dict[str, Any]] = {
                name: {"type": self._types[name],
                       "help": self._help.get(name, ""),
                       "samples": []}
                for name in sorted(self._types)
            }
            entries = [(k, p, False) for k, p in self._prims.items()]
            entries += [(k, c, True) for k, c in self._callbacks.items()]
            entries.sort(key=lambda e: (e[0][0], e[0][1]))
            for (name, lkey), obj, is_cb in entries:
                if is_cb:
                    value: Any = obj()
                    if self._types[name] != "histogram":
                        value = float(value)
                        if value == int(value):
                            value = int(value)
                else:
                    value = obj.value
                out[name]["samples"].append(
                    {"labels": dict(lkey), "value": value})
            return out

    def snapshot(self) -> Dict[str, Any]:
        """Stable JSON document: the one telemetry schema for the repo."""
        return {"schema": SNAPSHOT_SCHEMA, "metrics": self._collect()}

    def snapshot_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def exposition(self) -> str:
        """Prometheus-style text exposition."""
        lines: List[str] = []
        for name, fam in self._collect().items():
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for sample in fam["samples"]:
                lbl = _fmt_labels(sample["labels"])
                if fam["type"] == "histogram":
                    v = sample["value"]
                    for le, c in v["buckets"].items():
                        blbl = _fmt_labels({**sample["labels"], "le": le})
                        lines.append(f"{name}_bucket{blbl} {c}")
                    lines.append(f"{name}_sum{lbl} {v['sum']}")
                    lines.append(f"{name}_count{lbl} {v['count']}")
                else:
                    lines.append(f"{name}{lbl} {sample['value']}")
        return "\n".join(lines) + "\n"


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"

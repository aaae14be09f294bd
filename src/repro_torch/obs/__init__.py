"""``repro_torch.obs`` — process-wide observability: span tracing + metrics.

The port's copy of ``repro.obs``; the port imports nothing of the
reference, so it keeps its own:

* :mod:`repro_torch.obs.tracing` — a bounded-ring :class:`Tracer`
  emitting per-request and per-engine spans with wall-clock *and*
  deterministic engine-tick timestamps, exported as Chrome trace-event
  JSON (one track per replica, one per request). :data:`NULL_TRACER` is
  the always-installed no-op default.
* :mod:`repro_torch.obs.registry` — typed :class:`Counter` /
  :class:`Gauge` / :class:`Histogram` primitives plus callback collectors
  in one lock-protected :class:`MetricsRegistry`, with a stable JSON
  snapshot schema (:data:`SNAPSHOT_SCHEMA`) and a Prometheus-style text
  exposition. The serving engine, router, cache pool, fault injector and
  graph cache all register into one registry.
* :mod:`repro_torch.obs.profiling` — ``torch.profiler.record_function``
  around the sandwich, butterfly, flash and paged-attention kernel call
  sites, under the reference's names, off unless asked for.

:mod:`repro_torch.obs.validate` structurally validates Chrome trace-event
JSON: ``python -m repro_torch.obs.validate trace.json``.
"""

from repro_torch.obs.registry import (SNAPSHOT_SCHEMA, Counter, Gauge,
                                      Histogram, MetricsRegistry)
from repro_torch.obs.tracing import NULL_TRACER, NullTracer, Tracer

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "SNAPSHOT_SCHEMA",
]

"""Serving metrics: per-request latency decomposition + engine counters.

A copy of ``repro.serve.metrics`` for the port, with the same counters,
snapshot keys and meanings, so that one trace served by both engines can
be compared counter for counter. The snapshot adds two keys of its own:
``build`` (the ticks that built a graph entry and their wall time) and
``decode_tok_per_s_steady`` (decode tokens/s over the other ticks). Two
clocks run through every record:

* **wall time** (``time.monotonic``) — TTFT, TPOT, end-to-end latency,
  steady-state tokens/s.
* **engine ticks** — the deterministic clock tests assert against: one
  tick = one :meth:`ServeEngine.step`. Tick ordering proves scheduling
  properties (continuous batching, slot refill, preemption) without
  depending on machine speed.

``EngineMetrics.snapshot()`` returns a plain-JSON dict.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional


@dataclass
class RequestMetrics:
    """Lifecycle of one request through the engine."""

    rid: int
    prompt_len: int
    submit_t: float
    submit_tick: int
    admit_t: float = 0.0
    admit_tick: int = -1
    first_token_t: float = 0.0
    finish_t: float = 0.0
    finish_tick: int = -1
    new_tokens: int = 0
    preemptions: int = 0             # times this request was kicked+requeued

    @property
    def ttft(self) -> float:
        """Time to first token (s): submit -> first sampled token (which the
        engine emits at admission, straight off the prefill logits)."""
        return self.first_token_t - self.submit_t

    @property
    def tpot(self) -> float:
        """Time per output token (s) across the decode phase; 0 for
        single-token requests."""
        if self.new_tokens <= 1:
            return 0.0
        return (self.finish_t - self.first_token_t) / (self.new_tokens - 1)

    @property
    def latency(self) -> float:
        return self.finish_t - self.submit_t

    def to_dict(self) -> Dict:
        return {
            "rid": self.rid, "prompt_len": self.prompt_len,
            "new_tokens": self.new_tokens,
            "ttft_ms": round(self.ttft * 1e3, 3),
            "tpot_ms": round(self.tpot * 1e3, 3),
            "latency_ms": round(self.latency * 1e3, 3),
            "queue_ticks": self.admit_tick - self.submit_tick,
            "admit_tick": self.admit_tick, "finish_tick": self.finish_tick,
            "preemptions": self.preemptions,
        }


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list (no numpy dependency
    in the snapshot path).

    Explicit ceil-based nearest rank — the smallest value with at least a
    ``q`` fraction of the sample at or below it: rank ``ceil(q * n)``
    (1-based), clamped to the sample. Python's ``round()`` (banker's
    rounding) picked the lower rank inconsistently on even-length
    windows; the ceil convention is deterministic and standard (pinned by
    unit tests over 1/2/3/20-element windows in ``tests/test_serve.py``).
    """
    if not sorted_vals:
        return 0.0
    rank = math.ceil(q * len(sorted_vals))
    return sorted_vals[min(len(sorted_vals) - 1, max(0, rank - 1))]


@dataclass
class EngineMetrics:
    """Engine-level counters, accumulated by :class:`ServeEngine`.

    Memory is bounded for a long-lived engine: only *in-flight* requests
    live in ``requests``; finished ones move into a
    ``max_request_history``-bounded deque (their :class:`RequestMetrics`
    object stays alive on the caller's ``GenerationResult`` regardless),
    while the lifetime totals (``requests_finished`` / ``finished_tokens``)
    keep counting. Percentiles in :meth:`snapshot` are therefore over the
    most recent ``max_request_history`` finished requests.

    Thread-safety: the tick thread mutates these counters while a client
    thread may call :meth:`snapshot` (a periodic dump, a health probe) —
    every recorder and every reader therefore takes one internal re-entrant
    lock. Mutate ONLY through the ``on_*`` recorders; bare
    ``metrics.field += 1`` from outside this class would bypass the lock.
    """

    slots: int
    max_request_history: int = 1024
    ticks: int = 0
    decode_steps: int = 0
    decode_tokens: int = 0           # tokens emitted by pooled decode ticks
    prefill_tokens: int = 0          # prompt tokens processed (pre-padding)
    prefills: int = 0
    chunk_ticks: int = 0             # chunked-prefill pool invocations
    occupied_slot_ticks: int = 0     # Σ active slots over decode ticks
    decode_time_s: float = 0.0       # wall time inside pooled decode calls
    build_ticks: int = 0             # decode/chunk calls that built a graph
    build_time_s: float = 0.0        # wall time of those calls (set-up)
    build_decode_tokens: int = 0     # tokens of the decode calls among them
    build_decode_time_s: float = 0.0
    prefill_time_s: float = 0.0      # wall time inside prefill calls
    requests_finished: int = 0       # lifetime total
    finished_tokens: int = 0         # lifetime total over finished requests
    max_concurrent_slots: int = 0    # high-water mark of occupied slots
    pool_kind: str = "paged"         # cache pool flavor: paged or dense
    admission: str = "eager"         # page reservation policy
    total_pages: int = 0             # physical pages incl. the trash page
    pages_in_use: int = 0            # gauge, engine-synced after alloc/free
    pages_hwm: int = 0               # allocator high-water mark
    pool_exhausted_events: int = 0   # admissions/growth deferred or kicked
    preempted: int = 0               # slots kicked mid-flight for pages
    recompute_tokens: int = 0        # already-computed tokens re-prefilled
    cancelled: int = 0               # requests cancelled by the client
    rejected_queue_full: int = 0     # submits shed by the bounded queue
    deadline_expired: int = 0        # requests failed on their deadline
    spec_k: int = 0                  # draft tokens proposed per slot tick
    spec_ticks: int = 0              # speculative decode pool invocations
    draft_tokens: int = 0            # Σ draft proposals over live slots
    accepted_draft_tokens: int = 0   # Σ verified-accepted draft proposals
    requests: Dict[int, RequestMetrics] = field(default_factory=dict)
    clock: object = time.monotonic

    def __post_init__(self):
        self._history: Deque[RequestMetrics] = collections.deque(
            maxlen=self.max_request_history)
        # re-entrant: snapshot() composes finished() under the same lock
        self._lock = threading.RLock()

    # -- recording (engine-internal) -----------------------------------

    def request(self, rid: int) -> Optional[RequestMetrics]:
        with self._lock:
            return self.requests.get(rid)

    def on_submit(self, rid: int, prompt_len: int) -> RequestMetrics:
        with self._lock:
            rm = RequestMetrics(rid=rid, prompt_len=prompt_len,
                                submit_t=self.clock(),
                                submit_tick=self.ticks)
            self.requests[rid] = rm
            return rm

    def on_admit(self, rid: int) -> None:
        with self._lock:
            rm = self.requests[rid]
            rm.admit_t = self.clock()
            rm.admit_tick = self.ticks

    def on_tick(self) -> None:
        """One engine tick completed (the deterministic clock)."""
        with self._lock:
            self.ticks += 1

    def on_prefill_work(self, tokens: int, dt: float, chunked: bool = False,
                        build: bool = False) -> None:
        """Prompt tokens pushed through a prefill call (a whole prompt, or
        one chunked-prefill pool tick: ``chunked``); ``build``: the call
        built its graph entry (warm-up and capture)."""
        with self._lock:
            self.prefill_tokens += tokens
            self.prefill_time_s += dt
            if chunked:
                self.chunk_ticks += 1
            if build:
                self.build_ticks += 1
                self.build_time_s += dt

    def on_prefill_done(self) -> None:
        with self._lock:
            self.prefills += 1

    def on_first_token(self, rid: int) -> None:
        """The request's first token was sampled (straight off the prefill
        logits — at admission for bucketed prefill, at final-chunk
        completion for chunked prefill)."""
        with self._lock:
            rm = self.requests[rid]
            rm.first_token_t = self.clock()
            rm.new_tokens = 1

    def on_decode_tick(self, active_slots: int, new_tokens: int,
                       dt: float, build: bool = False) -> None:
        """One pooled decode tick; ``build``: it built a graph entry (its
        time is set-up, kept apart in the snapshot's ``build``)."""
        with self._lock:
            self.decode_steps += 1
            self.occupied_slot_ticks += active_slots
            self.decode_tokens += new_tokens
            self.decode_time_s += dt
            if build:
                self.build_ticks += 1
                self.build_time_s += dt
                self.build_decode_tokens += new_tokens
                self.build_decode_time_s += dt

    def on_occupancy(self, occupied_slots: int) -> None:
        with self._lock:
            self.max_concurrent_slots = max(self.max_concurrent_slots,
                                            occupied_slots)

    def on_pool_exhausted(self) -> None:
        """An admission or page-growth attempt hit ``PoolExhausted``."""
        with self._lock:
            self.pool_exhausted_events += 1

    def sync_pool(self, pool) -> None:
        """Refresh the page-pool gauges from a
        :class:`repro_torch.serve.cache.PagedCachePool`."""
        with self._lock:
            self.pages_in_use = pool.pages_in_use
            self.pages_hwm = pool.pages_hwm

    def on_token(self, rid: int, n: int = 1) -> None:
        """``n`` tokens committed to the request's output stream (n > 1
        only under speculative decoding, where a tick can commit up to
        ``spec_k + 1`` tokens per slot)."""
        with self._lock:
            self.requests[rid].new_tokens += n

    def on_spec_tick(self, drafted: int, accepted: int) -> None:
        """One speculative decode tick: ``drafted`` proposals went into the
        verify pass across live slots, ``accepted`` survived it. The bonus
        token each slot gets from the verify logits themselves is *not* a
        draft token and is excluded from both counters, so
        ``acceptance_rate`` isolates draft-head quality."""
        with self._lock:
            self.spec_ticks += 1
            self.draft_tokens += drafted
            self.accepted_draft_tokens += accepted

    def on_preempt(self, rid: int, computed_tokens: int) -> None:
        """A slot was kicked for pages; ``computed_tokens`` is the prefix
        (prompt positions prefilled + tokens decoded) that must be
        recomputed via chunked prefill on re-admission."""
        with self._lock:
            self.preempted += 1
            self.recompute_tokens += computed_tokens
            rm = self.requests.get(rid)
            if rm is not None:
                rm.preemptions += 1

    def on_cancel(self, rid: int) -> None:
        """The request was cancelled: evict its record without entering the
        finished history (it produced no result to aggregate)."""
        with self._lock:
            self.cancelled += 1
            self.requests.pop(rid, None)

    def on_deadline(self, rid: int) -> None:
        """The request blew its deadline: evict like a cancel."""
        with self._lock:
            self.deadline_expired += 1
            self.requests.pop(rid, None)

    def on_queue_full(self) -> None:
        with self._lock:
            self.rejected_queue_full += 1

    def evict(self, rid: int) -> Optional[RequestMetrics]:
        """Remove and return an in-flight record without counting it
        anywhere — the abort sweep and the router's drain-requeue path
        (where :meth:`adopt` re-registers it on another replica)."""
        with self._lock:
            return self.requests.pop(rid, None)

    def adopt(self, rm: RequestMetrics) -> None:
        """Re-register a record evicted from another replica (router
        requeue). Wall-clock fields survive the move, so TTFT/latency
        still span from the ORIGINAL submit; ``submit_tick`` is rebased
        to this engine's tick clock (tick clocks are per-engine, and
        ``deadline_ticks`` is measured against it)."""
        with self._lock:
            rm.submit_tick = self.ticks
            rm.admit_tick = -1
            self.requests[rm.rid] = rm

    def on_finish(self, rid: int) -> RequestMetrics:
        """Finalize + evict a request's record (bounded-history move);
        returns it so the engine can attach it to the GenerationResult."""
        with self._lock:
            rm = self.requests.pop(rid)
            rm.finish_t = self.clock()
            rm.finish_tick = self.ticks
            self._history.append(rm)
            self.requests_finished += 1
            self.finished_tokens += rm.new_tokens
            return rm

    # -- reporting -----------------------------------------------------

    def finished(self) -> List[RequestMetrics]:
        """The most recent ``max_request_history`` finished requests."""
        with self._lock:
            return list(self._history)

    def snapshot(self) -> Dict:
        """JSON-able summary: throughput, latency percentiles, occupancy.
        Percentiles and the per-request list cover the bounded recent
        window; the ``requests_finished``/``total_tokens`` counters are
        lifetime totals. Safe to call from any thread while the tick thread
        records (one consistent cut under the metrics lock)."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> Dict:
        done = self.finished()
        ttfts = sorted(r.ttft for r in done)
        tpots = sorted(r.tpot for r in done if r.new_tokens > 1)
        occupancy = (self.occupied_slot_ticks
                     / (self.slots * max(1, self.decode_steps)))
        return {
            "slots": self.slots,
            "ticks": self.ticks,
            "requests_finished": self.requests_finished,
            "prefills": self.prefills,
            "prefill_tokens": self.prefill_tokens,
            "chunk_ticks": self.chunk_ticks,
            "max_concurrent_slots": self.max_concurrent_slots,
            "cancelled": self.cancelled,
            "rejected_queue_full": self.rejected_queue_full,
            "deadline_expired": self.deadline_expired,
            "preempted": self.preempted,
            "recompute_tokens": self.recompute_tokens,
            "pool": {
                "kind": self.pool_kind,
                "admission": self.admission,
                "total_pages": self.total_pages,
                "pages_in_use": self.pages_in_use,
                "pages_hwm": self.pages_hwm,
                "exhausted_events": self.pool_exhausted_events,
                "preempted": self.preempted,
                "recompute_tokens": self.recompute_tokens,
            },
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "total_tokens": self.finished_tokens,
            "spec": {
                "k": self.spec_k,
                "ticks": self.spec_ticks,
                "draft_tokens": self.draft_tokens,
                "accepted_draft_tokens": self.accepted_draft_tokens,
                "acceptance_rate": round(
                    self.accepted_draft_tokens / self.draft_tokens, 4)
                    if self.draft_tokens else 0.0,
                "tokens_per_slot_tick": round(
                    self.decode_tokens / max(1, self.occupied_slot_ticks), 4),
            },
            "decode_tok_per_s": (self.decode_tokens / self.decode_time_s
                                 if self.decode_time_s else 0.0),
            # the port's own: the ticks that built a graph entry (on CUDA
            # an eager warm-up plus the capture) are set-up; the steady
            # rate leaves them out
            "build": {"ticks": self.build_ticks,
                      "time_s": self.build_time_s},
            "decode_tok_per_s_steady": (
                (self.decode_tokens - self.build_decode_tokens)
                / (self.decode_time_s - self.build_decode_time_s)
                if self.decode_time_s > self.build_decode_time_s else 0.0),
            "slot_occupancy": round(occupancy, 4),
            "ttft_ms": {
                "p50": round(_percentile(ttfts, 0.50) * 1e3, 3),
                "p95": round(_percentile(ttfts, 0.95) * 1e3, 3),
            },
            "tpot_ms": {
                "p50": round(_percentile(tpots, 0.50) * 1e3, 3),
                "p95": round(_percentile(tpots, 0.95) * 1e3, 3),
            },
            "requests": [r.to_dict() for r in
                         sorted(done, key=lambda r: r.rid)],
        }

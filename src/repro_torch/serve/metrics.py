"""Serving metrics: per-request latency decomposition + engine counters.

A copy of ``repro.serve.metrics`` reduced to what the port's engine
records. Two clocks run through every record:

* **wall time** (``time.monotonic``) — TTFT, TPOT, end-to-end latency,
  steady-state tokens/s.
* **engine ticks** — the deterministic clock tests assert against: one
  tick = one :meth:`ServeEngine.step`.

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

    @property
    def ttft(self) -> float:
        """Time to first token (s): submit -> first sampled token (off the
        final prefill chunk's logits)."""
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
        }


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list: rank ``ceil(q * n)``
    (1-based), clamped to the sample."""
    if not sorted_vals:
        return 0.0
    rank = math.ceil(q * len(sorted_vals))
    return sorted_vals[min(len(sorted_vals) - 1, max(0, rank - 1))]


@dataclass
class EngineMetrics:
    """Engine-level counters, accumulated by :class:`ServeEngine`.

    Only in-flight requests live in ``requests``; finished ones move into a
    ``max_request_history``-bounded deque while the lifetime totals keep
    counting. Every recorder and reader takes one internal re-entrant lock,
    so a client thread may call :meth:`snapshot` while the driver records.
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
    prefill_time_s: float = 0.0      # wall time inside prefill calls
    requests_finished: int = 0       # lifetime total
    finished_tokens: int = 0         # lifetime total over finished requests
    max_concurrent_slots: int = 0    # high-water mark of occupied slots
    pool_kind: str = "paged"
    admission: str = "eager"
    total_pages: int = 0             # physical pages incl. the trash page
    pages_in_use: int = 0
    pages_hwm: int = 0
    pool_exhausted_events: int = 0   # admissions deferred on PoolExhausted
    requests: Dict[int, RequestMetrics] = field(default_factory=dict)
    clock: object = time.monotonic

    def __post_init__(self):
        self._history: Deque[RequestMetrics] = collections.deque(
            maxlen=self.max_request_history)
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
        with self._lock:
            self.ticks += 1

    def on_prefill_work(self, tokens: int, dt: float) -> None:
        """Prompt tokens pushed through one chunked-prefill pool tick."""
        with self._lock:
            self.prefill_tokens += tokens
            self.prefill_time_s += dt
            self.chunk_ticks += 1

    def on_prefill_done(self) -> None:
        with self._lock:
            self.prefills += 1

    def on_first_token(self, rid: int) -> None:
        with self._lock:
            rm = self.requests[rid]
            rm.first_token_t = self.clock()
            rm.new_tokens = 1

    def on_decode_tick(self, active_slots: int, new_tokens: int,
                       dt: float) -> None:
        with self._lock:
            self.decode_steps += 1
            self.occupied_slot_ticks += active_slots
            self.decode_tokens += new_tokens
            self.decode_time_s += dt

    def on_occupancy(self, occupied_slots: int) -> None:
        with self._lock:
            self.max_concurrent_slots = max(self.max_concurrent_slots,
                                            occupied_slots)

    def on_pool_exhausted(self) -> None:
        with self._lock:
            self.pool_exhausted_events += 1

    def sync_pool(self, pool) -> None:
        with self._lock:
            self.pages_in_use = pool.pages_in_use
            self.pages_hwm = pool.pages_hwm

    def on_token(self, rid: int, n: int = 1) -> None:
        with self._lock:
            self.requests[rid].new_tokens += n

    def on_finish(self, rid: int) -> RequestMetrics:
        """Finalize + evict a request's record (bounded-history move)."""
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
        with self._lock:
            return list(self._history)

    def snapshot(self) -> Dict:
        """JSON-able summary: throughput, latency percentiles, occupancy."""
        with self._lock:
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
                "pool": {
                    "kind": self.pool_kind,
                    "admission": self.admission,
                    "total_pages": self.total_pages,
                    "pages_in_use": self.pages_in_use,
                    "pages_hwm": self.pages_hwm,
                    "exhausted_events": self.pool_exhausted_events,
                },
                "decode_steps": self.decode_steps,
                "decode_tokens": self.decode_tokens,
                "total_tokens": self.finished_tokens,
                "decode_tok_per_s": (self.decode_tokens / self.decode_time_s
                                     if self.decode_time_s else 0.0),
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

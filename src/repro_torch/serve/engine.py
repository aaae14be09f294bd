"""Continuous-batching inference engine of the port.

Counterpart of ``repro.serve.engine.ServeEngine``, reduced to its main
path. The engine owns ``slots`` decode lanes over one paged KV pool
(:class:`~repro_torch.serve.cache.PagedCachePool`) and runs a strict tick
loop:

  1. **Admit** — while a slot is free and requests are queued, pop one and
     reserve its whole token budget (``prompt + max_new_tokens``) in pages
     (eager admission). A pool that cannot cover it leaves the request
     queued until finished requests free pages.
  2. **Chunked prefill** — admitted prompts advance one fixed-size chunk
     (``prefill_chunk`` tokens) per tick through one pool-wide call. A slot
     whose final chunk lands samples its first token from the chunk logits
     and joins this very tick's decode.
  3. **Decode** — one pooled step advances every decoding slot by one token
     (per-slot positions, page tables and active masks). Finished slots
     resolve their futures and free their pages; the next tick's admission
     refills them.

The port runs eagerly: there is no compile cache, and each tick is a
sequence of kernel launches on the current CUDA stream. Sampling draws
from one ``torch.Generator`` seeded from ``seed``.

Threading model: ``submit()`` is thread-safe; ``step()`` /
``run_until_idle()`` must be driven from one thread.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.context import resolve_device
from repro_torch.models.lm import LM
from repro_torch.serve import sampling as sampling_lib
from repro_torch.serve import steps as steps_lib
from repro_torch.serve.cache import PagedCachePool, PoolExhausted
from repro_torch.serve.metrics import EngineMetrics, RequestMetrics


@dataclass(frozen=True, eq=False)
class Request:
    """One generation request. ``prompt`` is normalized to a tuple of ints.
    ``sampling=None`` means the engine-wide policy; a non-None value must
    equal it. ``rid=None`` lets the engine assign its sequence number."""

    prompt: Tuple[int, ...]
    max_new_tokens: int = 16
    sampling: Optional[sampling_lib.SamplingParams] = None
    stop_token: Optional[int] = None
    rid: Optional[int] = None

    def __post_init__(self):
        prompt = tuple(int(t) for t in
                       np.asarray(self.prompt, np.int32).reshape(-1))
        object.__setattr__(self, "prompt", prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")


@dataclass
class GenerationResult:
    """What a request's future resolves to."""

    rid: int
    prompt: np.ndarray
    tokens: List[int]                      # all generated tokens, in order
    metrics: RequestMetrics


@dataclass
class _Slot:
    """Host-side state of one queued request or occupied decode lane."""

    req: Request
    rid: int
    future: Future
    prompt: np.ndarray
    tokens: List[int] = field(default_factory=list)
    cur_pos: int = 0                       # absolute cache write position
    last_token: int = -1
    prefilled: int = -1                    # prompt tokens prefilled so far;
    #                                        -1 = not in the chunk phase

    @property
    def prefilling(self) -> bool:
        return 0 <= self.prefilled < self.prompt.size

    @property
    def decoding(self) -> bool:
        return not self.prefilling


class ServeEngine:
    """Continuous-batching engine over a fixed decode-slot pool.

    * ``model`` — a :class:`repro_torch.models.lm.LM`; moved to ``device``.
    * ``slots`` — decode lanes (the pooled batch of the serve step).
    * ``max_len`` — per-slot budget: ``prompt_len + max_new_tokens <=
      max_len``.
    * ``page_size`` / ``num_pages`` — paged-pool geometry; ``num_pages``
      defaults to dense-equivalent capacity plus the trash page.
    * ``prefill_chunk`` — chunked-prefill chunk size.
    * ``sampling`` — engine-wide :class:`SamplingParams` (greedy default).
    * ``device`` — ``None`` means ``cuda`` and raises without a card; pass
      ``"cpu"`` to serve through the plain PyTorch versions.
    """

    def __init__(self, cfg: ModelConfig, model: LM, *, slots: int = 4,
                 max_len: int = 128, page_size: int = 16,
                 num_pages: Optional[int] = None, prefill_chunk: int = 16,
                 sampling: sampling_lib.SamplingParams = sampling_lib.GREEDY,
                 seed: int = 0,
                 device: Union[str, torch.device, None] = None):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.slots = slots
        self.max_len = int(max_len)
        self.prefill_chunk = int(prefill_chunk)
        self.sampling = sampling
        self.pool = PagedCachePool(cfg, slots, self.max_len,
                                   page_size=page_size, num_pages=num_pages,
                                   device=self.device)
        self._caches = self.pool.init()
        self._slots: List[Optional[_Slot]] = [None] * slots
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._next_rid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._sample_fn = functools.partial(sampling_lib.sample_logits,
                                            params=sampling)
        self._decode_step = steps_lib.make_pool_serve_step(
            self.model, self._sample_fn)
        self._chunk_step = steps_lib.make_chunk_prefill_step(self.model)
        self.metrics = EngineMetrics(slots=slots, pool_kind="paged",
                                     admission="eager",
                                     total_pages=self.pool.total_pages)

    # -- client surface ------------------------------------------------

    def submit(self, request: Request) -> Future:
        """Queue a :class:`Request`; returns a future resolving to a
        :class:`GenerationResult`. Thread-safe."""
        if not isinstance(request, Request):
            raise TypeError(f"submit() takes a Request, got "
                            f"{type(request).__name__}")
        plen = len(request.prompt)
        if plen + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt_len {plen} + max_new_tokens "
                f"{request.max_new_tokens} exceeds the engine's per-slot "
                f"budget max_len={self.max_len}")
        if (request.sampling is not None
                and request.sampling != self.sampling):
            raise ValueError(
                "per-request sampling must match the engine-wide policy "
                f"(engine: {self.sampling}, request: {request.sampling})")
        need = self.pool.pages_for(plen + request.max_new_tokens)
        if need > self.pool.total_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.pool.total_pages - 1} usable pages")
        with self._lock:
            if request.rid is None:
                rid = self._next_rid
            else:
                rid = int(request.rid)
                if self.metrics.request(rid) is not None:
                    raise ValueError(f"rid {rid} is already in flight")
            self._next_rid = max(self._next_rid, rid) + 1
            slot = _Slot(req=request, rid=rid, future=Future(),
                         prompt=np.asarray(request.prompt, np.int32))
            self.metrics.on_submit(rid, slot.prompt.size)
            self._queue.append(slot)
        return slot.future

    def has_work(self) -> bool:
        with self._lock:
            queued = bool(self._queue)
        return queued or any(s is not None for s in self._slots)

    def occupied_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    def queued(self) -> int:
        with self._lock:
            return len(self._queue)

    def active_requests(self) -> List[int]:
        return [s.rid for s in self._slots if s is not None]

    @property
    def caches(self) -> Dict[str, torch.Tensor]:
        """The live KV pool ``{"k", "v"}``, written in place every tick."""
        return self._caches

    # -- the tick loop -------------------------------------------------

    def step(self) -> int:
        """One engine tick: admit into free slots, advance chunked prefills
        by one chunk, then one pooled decode. Returns the number of slots
        still active after the tick."""
        self._admit()
        self.metrics.on_occupancy(self.occupied_slots())
        self._chunk_tick()
        if any(s is not None and s.decoding for s in self._slots):
            self._decode_tick()
        self.metrics.on_tick()
        return self.occupied_slots()

    def run_until_idle(self, max_ticks: int = 100_000) -> int:
        """Drive ticks until queue and pool drain; returns ticks spent."""
        start = self.metrics.ticks
        while self.has_work():
            self.step()
            if self.metrics.ticks - start > max_ticks:
                raise RuntimeError(
                    f"engine did not drain within {max_ticks} ticks "
                    f"(active={self.active_requests()})")
        return self.metrics.ticks - start

    def decode_logits(self, backend: str = "auto") -> torch.Tensor:
        """Logits (slots, V) of the pooled decode tick the engine would run
        next, under ``backend`` (:mod:`repro_torch.kernels.context`), on a
        copy of the KV pool: the engine's caches and host state are
        untouched. For holding one backend against another on live engine
        state."""
        if not any(s is not None and s.decoding for s in self._slots):
            raise RuntimeError("no slot is decoding")
        caches = {t: c.clone() for t, c in self._caches.items()}
        tokens, cur_pos, active = self.decode_inputs()
        _, logits = self._decode_step(
            tokens, caches, cur_pos, active,
            self.pool.gather_args()["page_table"], self._gen,
            backend=backend)
        return logits

    # -- internals -----------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _admit(self) -> None:
        while True:
            idx = next((i for i, s in enumerate(self._slots) if s is None),
                       None)
            if idx is None:
                return
            with self._lock:
                if not self._queue:
                    return
                slot = self._queue[0]
            try:
                self.pool.alloc_pages(
                    idx, int(slot.prompt.size) + slot.req.max_new_tokens)
            except PoolExhausted:
                # keep FIFO order: the head request waits for pages
                self.metrics.on_pool_exhausted()
                return
            with self._lock:
                self._queue.popleft()
            self.metrics.sync_pool(self.pool)
            self.metrics.on_admit(slot.rid)
            slot.prefilled = 0
            self._slots[idx] = slot

    def _chunk_tick(self) -> None:
        """Advance every prefilling slot by one prompt chunk (one pooled
        call); slots whose final chunk lands sample their first token."""
        live = [(i, s) for i, s in enumerate(self._slots)
                if s is not None and s.prefilling]
        if not live:
            return
        C = self.prefill_chunk
        tokens = np.zeros((self.slots, C), np.int32)
        start = np.zeros((self.slots,), np.int32)
        last = np.zeros((self.slots,), np.int32)
        active = np.zeros((self.slots,), bool)
        spans = {}
        for i, s in live:
            lo = s.prefilled
            hi = min(lo + C, int(s.prompt.size))
            tokens[i, :hi - lo] = s.prompt[lo:hi]
            start[i] = lo
            last[i] = hi - lo - 1
            active[i] = True
            spans[i] = (lo, hi)
        t0 = time.monotonic()
        logits, _ = self._chunk_step(
            self._tensor(tokens), self._caches, self._tensor(start),
            self._tensor(last), self._tensor(active),
            self.pool.gather_args()["page_table"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.metrics.on_prefill_work(
            sum(hi - lo for lo, hi in spans.values()), time.monotonic() - t0)
        done = [i for i, s in live if spans[i][1] == s.prompt.size]
        first = {}
        if done:
            rows = self._tensor(np.asarray(done, np.int64))
            with torch.no_grad():
                toks = self._sample_fn(logits[rows], self._gen)
            first = dict(zip(done, toks.cpu().tolist()))
        finishers = []
        for i, s in live:
            s.prefilled = spans[i][1]
            if i not in first:
                continue
            self.metrics.on_prefill_done()
            self.metrics.on_first_token(s.rid)
            s.tokens.append(int(first[i]))
            s.last_token = int(first[i])
            s.cur_pos = int(s.prompt.size)
            s.prefilled = -1                # decode phase
            if self._finished(s):
                finishers.append(i)
        for i in finishers:
            self._finish(i)

    def decode_inputs(self) -> Tuple[torch.Tensor, ...]:
        """``(tokens, cur_pos, active)``, each ``(slots,)``, of the pooled
        decode tick the engine would run next."""
        tokens = np.zeros((self.slots,), np.int32)
        cur_pos = np.zeros((self.slots,), np.int32)
        active = np.zeros((self.slots,), bool)
        for i, s in enumerate(self._slots):
            if s is None or s.prefilling:
                continue
            tokens[i] = s.last_token
            cur_pos[i] = s.cur_pos
            active[i] = True
        return self._tensor(tokens), self._tensor(cur_pos), \
            self._tensor(active)

    def _decode_tick(self) -> None:
        tokens, cur_pos, active = self.decode_inputs()
        t0 = time.monotonic()
        nxt, _ = self._decode_step(tokens, self._caches, cur_pos, active,
                                   self.pool.gather_args()["page_table"],
                                   self._gen)
        nxt = nxt.cpu().tolist()
        n_active = sum(s is not None and s.decoding for s in self._slots)
        self.metrics.on_decode_tick(n_active, n_active,
                                    time.monotonic() - t0)
        for i, s in enumerate(self._slots):
            if s is None or s.prefilling:
                continue
            s.tokens.append(int(nxt[i]))
            s.last_token = int(nxt[i])
            s.cur_pos += 1
            self.metrics.on_token(s.rid)
            if self._finished(s):
                self._finish(i)

    def _finished(self, slot: _Slot) -> bool:
        if len(slot.tokens) >= slot.req.max_new_tokens:
            return True
        stop = slot.req.stop_token
        return stop is not None and slot.last_token == stop

    def _finish(self, idx: int) -> None:
        slot = self._slots[idx]
        self._slots[idx] = None
        rm = self.metrics.on_finish(slot.rid)
        self.pool.free(idx)
        self.metrics.sync_pool(self.pool)
        slot.future.set_result(GenerationResult(
            rid=slot.rid, prompt=slot.prompt, tokens=list(slot.tokens),
            metrics=rm))

"""Continuous-batching inference engine of the port.

Counterpart of ``repro.serve.engine.ServeEngine``. The engine owns
``slots`` decode lanes over one KV pool (``pool="paged"``:
:class:`~repro_torch.serve.cache.PagedCachePool`, with the ``local``
layers' rings beside its pages; ``pool="dense"``:
:class:`~repro_torch.serve.cache.DenseCachePool`, one full row per slot)
and runs a strict tick loop:

  0. **Lifecycle** — pending ``cancel(rid)`` calls and blown deadlines
     (``deadline_ticks``/``deadline_s``) resolve their futures with
     :class:`RequestCancelled`/:class:`DeadlineExceeded`, freeing slot and
     pages at once.
  1. **Admit** — while a slot is free and requests are queued, pop one and
     reserve pages for it: under ``admission="eager"`` its whole budget
     (``prompt + max_new_tokens``), deadlock-free with no preemption;
     under ``admission="incremental"`` only the prompt's pages. A pool that
     cannot cover the reservation leaves the request queued (backpressure).
     Without chunked prefill (the dense pool, ``prefill_chunk=None``/0,
     or an arch with rings, a frontend or an encoder) the whole prompt is
     prefilled here with the request's ``extras``, right-padded
     to a power-of-two bucket (:meth:`ServeEngine.bucket_for`; exact
     lengths for archs in :data:`SEQUENTIAL_STATE_BLOCKS`), eagerly (a
     length is seen once: a graph would cost more than it saves), into a
     fresh dense cache tree that the pool splices into the slot.
  2. **Grow / preempt** (incremental admission only) — every live slot's
     page table grows to cover this tick's writes, oldest slot first; when
     the pool runs out the youngest slot is preempted: its pages are freed
     and the request goes back to the queue head with its generated tokens
     appended to the prompt, to be recomputed through chunked prefill.
     Greedy decoding makes the resumed output token-identical to a
     never-preempted run (in float32; see ``PERF.md`` for bfloat16).
  3. **Chunked prefill** (the paged pool, full-attention archs) —
     admitted prompts advance one fixed-size chunk
     (``prefill_chunk`` tokens) per tick through one pool-wide step. A slot
     whose final chunk lands samples its first token from the chunk logits
     and joins this very tick's decode.
  4. **Decode** — one pooled step advances every decoding slot by one token
     (per-slot positions, page tables and active masks); or, with
     ``spec_k > 0``, a draft step proposes ``spec_k`` tokens per slot
     through the model's own head and one batched verify pass commits
     each slot's accepted prefix (1 to ``spec_k + 1`` tokens). Finished
     slots resolve their futures and free their pages; the next tick's
     admission refills them.

Every slot exit (finish, cancel, deadline, preempt, abort) goes through
one scrub-then-free tail, which under ``scrub_freed_slots`` zeroes the
slot's pages, rings and rows before they are recycled. A
:class:`~repro_torch.serve.faults.FaultInjector` passed as ``faults=``
forces exhaustion at ``pool.alloc`` and crashes at ``engine.tick`` on a
seeded schedule.

The steps run through a :class:`~repro_torch.serve.graphs.GraphCache`,
the counterpart of the reference's ``CompileCache``: on CUDA every
decode (paged or dense), chunk, draft and verify tick is the replay of
one CUDA graph captured once per key, with the host state copied into
the entry's static inputs first; sampling runs eagerly on the replayed
logits with one ``torch.Generator`` seeded from ``seed``.
:meth:`decode_logits` runs the next decode tick eagerly, the check a
replay is held against.

Execution policy: the engine resolves one
:class:`~repro_torch.kernels.context.ExecutionContext` at construction —
the explicit ``context=``, then this thread's ambient ``use_execution``
block, then the arch's ``ButterflyConfig`` — with ``"auto"`` turned into
its device's route, and every tick passes it to every kernel call. A
replay runs no Python, so no tick reads an ambient block: every tick runs
under ``frozen_execution`` of the engine's context, so a block entered
after construction changes nothing, eager or replayed, and the graph keys
need not carry the context.

On a mesh: a context with a mesh, from any layer of that order (the
explicit ``context=``, an ambient block, ``ButterflyConfig.mesh_shape``,
or a prebuilt ``mesh``), is resolved once here as well (a mesh larger
than the world raises, naming ``--simulated-devices`` and ``torchrun``;
an arch without butterfly sites is refused). Each tick then also opens
the mesh's sharding context, and every butterfly site runs through
:func:`repro_torch.runtime.butterfly_sharding.shard_batch_apply`: each
rank runs the sandwich kernel on its own rows and the rows are gathered
back, global in and global out; everything else (the paged decode,
attention, norms, sampling) runs whole on every rank. The port runs one
process a rank, so every rank holds an engine and the ranks must take
the same host decisions on every tick:
:mod:`repro_torch.serve.mesh_serve` mirrors rank 0's request stream and
clock to the others. A mesh of more than one rank ticks eagerly on a card
too (gloo collectives cannot be captured in a CUDA graph), with the CPU's
counters (``graphs.captures`` is false).

Observability, as the reference's engine: a ``tracer``
(:class:`repro_torch.obs.Tracer`; the no-op ``NULL_TRACER`` by default)
records the request lifecycle on per-request lanes (``tid = rid + 1``) and
the engine's ticks, chunks, decodes, page growth and graph builds
(``compile``) on the engine lane (``tid = 0``) of process row ``pid =
replica``; a ``registry`` (:class:`repro_torch.obs.MetricsRegistry`)
receives the reference's metric families as callbacks labelled
``{"replica": str(replica)}``, plus the ``serve_tick_seconds`` histogram;
:meth:`ServeEngine.telemetry` is the one document of both. Which spans
include device time is set out in :mod:`repro_torch.obs.tracing`.

Threading model: ``submit()`` and ``cancel()`` are thread-safe;
``step()`` / ``run_until_idle()`` must be driven from one thread
(:class:`repro_torch.serve.client.TickDriver` owns it). ``set_params()``
may come from another thread: it takes the lock ``step()`` holds, so
weights are never copied while a tick runs.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import context as exctx
from repro_torch.kernels.context import resolve_device
from repro_torch.models.lm import LM
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracing import NULL_TRACER, TRACK_ENGINE
from repro_torch.runtime import sharding as rsh
from repro_torch.serve import sampling as sampling_lib
from repro_torch.serve import steps as steps_lib
from repro_torch.serve.cache import (PoolExhausted,
                                     chunked_prefill_supported, make_pool,
                                     state_keys)
from repro_torch.serve.faults import SITES as FAULT_SITES
from repro_torch.serve.graphs import GraphCache, GraphEntry
from repro_torch.serve.metrics import EngineMetrics, RequestMetrics


#: block types whose caches mix positions sequentially (recurrent state) or
#: ring-buffer by position: right-padded bucket prefill would fold the pads
#: into the state or push real positions out of the ring, so these archs
#: prefill at exact prompt lengths. The engine's list, which adds
#: ``local`` to the cache's (:data:`repro_torch.serve.cache.
#: SEQUENTIAL_STATE_BLOCKS`), as the reference's engine does.
SEQUENTIAL_STATE_BLOCKS = ("rec", "mlstm", "slstm", "local")


class QueueFull(RuntimeError):
    """The bounded admission queue shed this submit (``queue_limit``
    queued requests already waiting): load-shedding, not a bug."""

    def __init__(self, limit: int):
        super().__init__(
            f"admission queue full ({limit} requests waiting); retry "
            f"later or raise queue_limit")
        self.limit = limit


class DeadlineExceeded(RuntimeError):
    """The request blew its ``deadline_ticks``/``deadline_s`` budget —
    queued or mid-decode — and was dropped, its slot and pages freed."""

    def __init__(self, rid: int, reason: str):
        super().__init__(f"request {rid} deadline exceeded: {reason}")
        self.rid = rid


class RequestCancelled(RuntimeError):
    """The request was cancelled via ``cancel(rid)`` before finishing."""

    def __init__(self, rid: int):
        super().__init__(f"request {rid} cancelled")
        self.rid = rid


@dataclass(frozen=True, eq=False)
class Request:
    """One generation request. ``prompt`` is normalized to a tuple of ints.
    ``sampling=None`` means the engine-wide policy; a non-None value must
    equal it. ``rid=None`` lets the engine assign its sequence number.
    Deadlines count from submission: ``deadline_ticks`` in engine ticks,
    ``deadline_s`` in wall seconds. ``extras`` holds a frontend's inputs,
    each (1, n, d_model): a ``vision`` arch's ``frontend_embeds`` and an
    encoder arch's ``frames``, stored as float32 numpy arrays;
    :meth:`ServeEngine.submit` checks them against its arch."""

    prompt: Tuple[int, ...]
    max_new_tokens: int = 16
    sampling: Optional[sampling_lib.SamplingParams] = None
    stop_token: Optional[int] = None
    extras: Optional[Mapping] = None
    rid: Optional[int] = None
    deadline_ticks: Optional[int] = None
    deadline_s: Optional[float] = None

    def __post_init__(self):
        prompt = tuple(int(t) for t in
                       np.asarray(self.prompt, np.int32).reshape(-1))
        object.__setattr__(self, "prompt", prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")
        if self.extras is not None:
            object.__setattr__(self, "extras", _checked_extras(self.extras))
        for name in ("deadline_ticks", "deadline_s"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")


#: the inputs a request's ``extras`` may carry
EXTRAS_KEYS = ("frontend_embeds", "frames")


def _checked_extras(extras: Mapping) -> Dict[str, np.ndarray]:
    """``extras`` as float32 arrays of shape (1, n, d), or ``ValueError``."""
    if not isinstance(extras, Mapping):
        raise ValueError(f"extras must be a mapping of "
                         f"{'/'.join(EXTRAS_KEYS)}, got "
                         f"{type(extras).__name__}")
    unknown = set(extras) - set(EXTRAS_KEYS)
    if unknown:
        raise ValueError(f"extras: unknown inputs {sorted(unknown)}; a "
                         f"request takes {'/'.join(EXTRAS_KEYS)}")
    out = {}
    for k, v in extras.items():
        a = np.asarray(v, np.float32)
        if a.ndim != 3 or a.shape[0] != 1:
            raise ValueError(f"extras[{k!r}] must be (1, n, d_model), got "
                             f"shape {a.shape}")
        out[k] = a
    return out


@dataclass
class GenerationResult:
    """What a request's future resolves to."""

    rid: int
    prompt: np.ndarray
    tokens: List[int]                      # all generated tokens, in order
    metrics: RequestMetrics


@dataclass
class _Slot:
    """Host-side state of one queued request or occupied decode lane.

    ``prompt`` is the original prompt the result reports; ``prefill_seq``
    is what the next admission prefills: ``prompt`` on first admission,
    ``prompt + tokens so far`` after a preemption. ``tokens`` survives
    preemption."""

    req: Request
    rid: int
    future: Future
    prompt: np.ndarray
    prefill_seq: np.ndarray = None         # defaults to prompt
    tokens: List[int] = field(default_factory=list)
    cur_pos: int = 0                       # absolute cache write position
    last_token: int = -1
    prefilled: int = -1                    # prefill_seq tokens prefilled
    #                                        so far; -1 = not in the chunk
    #                                        phase
    admit_seq: int = -1                    # admission order; the youngest
    #                                        (highest) is the preemption
    #                                        victim
    anchor: Optional[np.ndarray] = None    # (E,) float32 pre-final-norm
    #                                        state at the last committed
    #                                        input: the draft's seed
    trace_t0: float = 0.0                  # tracer time of the last queue
    #                                        entry (submit, preempt, adopt):
    #                                        the next "queue" span's start

    def __post_init__(self):
        if self.prefill_seq is None:
            self.prefill_seq = self.prompt

    @property
    def prefilling(self) -> bool:
        return 0 <= self.prefilled < self.prefill_seq.size

    @property
    def decoding(self) -> bool:
        return not self.prefilling


class ServeEngine:
    """Continuous-batching engine over a fixed decode-slot pool.

    * ``model`` — a :class:`repro_torch.models.lm.LM`; moved to ``device``.
    * ``slots`` — decode lanes (the pooled batch of the serve step).
    * ``max_len`` — per-slot budget: ``prompt_len + max_new_tokens <=
      max_len``.
    * ``pool`` — ``"paged"`` (default; dense for sequential-state archs)
      or ``"dense"`` (:func:`repro_torch.serve.cache.make_pool`).
    * ``page_size`` / ``num_pages`` — paged-pool geometry; ``num_pages``
      defaults to dense-equivalent capacity plus the trash page.
    * ``prefill_chunk`` — chunked-prefill chunk size on the paged pool of
      a full-attention arch; ``None``/0 admits whole prompts instead.
    * ``min_bucket`` — the smallest whole-prompt prefill bucket.
    * ``sampling`` — engine-wide :class:`SamplingParams` (greedy default).
    * ``admission`` — ``"eager"`` (whole-budget reservation) or
      ``"incremental"`` (prompt-only reservation, per-tick growth,
      preempt-youngest and recompute on exhaustion; needs chunked prefill).
    * ``spec_k`` — draft tokens per slot per tick (0 = off); greedy only,
      and needs chunked prefill.
    * ``queue_limit`` — a submit finding that many requests queued raises
      :class:`QueueFull`; ``None`` = unbounded.
    * ``faults`` — a :class:`repro_torch.serve.faults.FaultInjector` for
      the ``pool.alloc`` and ``engine.tick`` sites.
    * ``scrub_freed_slots`` — zero a slot's pages, rings and rows when its
      request exits.
    * ``device`` — ``None`` means ``cuda`` and raises without a card; pass
      ``"cpu"`` to serve through the plain PyTorch versions.
    * ``tracer`` — a :class:`repro_torch.obs.Tracer` for the span timeline;
      the no-op ``NULL_TRACER`` by default.
    * ``registry`` — a :class:`repro_torch.obs.MetricsRegistry` this engine
      registers its collectors into (share one across replicas); a private
      one by default (``engine.obs``).
    * ``replica`` — replica id: the trace ``pid`` and the ``replica``
      metric label.
    * ``context`` — the execution context (an ``ExecutionContext``, a
      backend string or ``None``), resolved once here and frozen
      (``engine.context``, its mesh ``engine.mesh``; module docstring).

    The attribute ``clock`` (``time.monotonic``) is the wall clock of the
    request metrics and of ``deadline_s``; :meth:`step`'s ``now`` overrides
    it for a tick's deadline pass. A mesh's mirror replaces it
    (:mod:`repro_torch.serve.mesh_serve`).
    """

    def __init__(self, cfg: ModelConfig, model: LM, *, slots: int = 4,
                 max_len: int = 128, pool: str = "paged",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = 16, min_bucket: int = 8,
                 sampling: sampling_lib.SamplingParams = sampling_lib.GREEDY,
                 admission: str = "eager", spec_k: int = 0,
                 queue_limit: Optional[int] = None, faults=None,
                 seed: int = 0, scrub_freed_slots: bool = False,
                 device: Union[str, torch.device, None] = None,
                 tracer=None, registry: Optional[MetricsRegistry] = None,
                 replica: int = 0, context: exctx.ContextLike = None):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        if admission not in ("eager", "incremental"):
            raise ValueError(f"unknown admission policy {admission!r}: "
                             f"expected 'eager' or 'incremental'")
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1 or None, got "
                             f"{queue_limit}")
        if prefill_chunk is not None and prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0 or None, got "
                             f"{prefill_chunk}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k and not sampling.greedy:
            raise ValueError(
                "spec_k > 0 requires greedy sampling (temperature=0): "
                "verification commits the model's argmax targets, which is "
                f"only lossless under greedy — got {sampling}")
        if (exctx.requests_mesh(
                context, exctx.ExecutionContext.from_butterfly_config(
                    cfg.butterfly))
                and not (cfg.butterfly is not None and cfg.butterfly.sites)):
            raise ValueError(
                f"a mesh shards the butterfly sites' rows, and {cfg.name} "
                f"has no butterfly sites: serve a butterfly arch (e.g. "
                f"smollm-135m-butterfly) on a mesh, or this one without")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pool = make_pool(cfg, slots, int(max_len), kind=pool,
                              page_size=page_size, num_pages=num_pages,
                              device=self.device)
        self.prefill_chunk = (
            int(prefill_chunk)
            if (prefill_chunk and self.pool.kind == "paged"
                and chunked_prefill_supported(cfg)) else None)
        if admission == "incremental" and self.prefill_chunk is None:
            raise ValueError(
                "admission='incremental' needs the paged pool with chunked "
                "prefill (preempted requests recompute through the chunk "
                f"path); this engine resolved pool={self.pool.kind!r}, "
                f"prefill_chunk={self.prefill_chunk!r} — use "
                "admission='eager' for this arch/pool")
        if spec_k and self.prefill_chunk is None:
            raise ValueError(
                "spec_k > 0 needs the paged pool with chunked prefill (the "
                "multi-position verify pass and the draft anchor ride the "
                f"chunk machinery); this engine resolved "
                f"pool={self.pool.kind!r}, "
                f"prefill_chunk={self.prefill_chunk!r} — use spec_k=0 for "
                "this arch/pool")
        types = set(cfg.block_unit) | set(cfg.tail_layers)
        self._exact_buckets = bool(types & set(SEQUENTIAL_STATE_BLOCKS))
        # a vision request's prefix tokens sit in its cache before its text
        self._n_front = (cfg.frontend_tokens if cfg.frontend == "vision"
                         else 0)
        self.min_bucket = int(min_bucket)
        self.context = exctx.resolve_for_device(
            context, self.device,
            default=exctx.ExecutionContext.from_butterfly_config(
                cfg.butterfly))
        self.mesh = self.context.mesh
        if self.mesh is not None and self.mesh.coordinate is None:
            from repro_torch.runtime import dist as rdist
            raise RuntimeError(f"rank {rdist.rank()} is not in the mesh "
                               f"{self.mesh.describe()}; it serves nothing")
        self.clock: Callable[[], float] = time.monotonic
        self.model = model.to(self.device)
        self.slots = slots
        self.max_len = int(max_len)
        self.sampling = sampling
        self.admission = admission
        self.spec_k = int(spec_k)
        self.queue_limit = queue_limit
        self.faults = faults
        self.scrub_freed_slots = scrub_freed_slots
        self.pool.faults = faults
        self._caches = self.pool.init()
        self._slots: List[Optional[_Slot]] = [None] * slots
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._step_lock = threading.Lock()     # a tick vs a weight copy
        self._next_rid = 0
        self._admit_seq = 0
        self._cancels: set = set()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._sample_fn = functools.partial(sampling_lib.sample_logits,
                                            params=sampling)
        self.replica = int(replica)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.obs = registry if registry is not None else MetricsRegistry()
        self._name_tracks()
        # a tick on a mesh of several ranks issues gloo collectives, which
        # a CUDA graph cannot capture: its entries run eagerly
        self.graphs = GraphCache(self.device, tracer=self.tracer,
                                 pid=self.replica,
                                 capture=self.mesh_ranks() == 1)
        self.metrics = self._fresh_metrics()
        self._tick_hist = self.obs.histogram(
            "serve_tick_seconds", "wall time per engine tick",
            labels={"replica": str(self.replica)})
        self._register_obs()

    def _fresh_metrics(self, history: int = 1024) -> EngineMetrics:
        return EngineMetrics(slots=self.slots, max_request_history=history,
                             pool_kind=self.pool.kind,
                             admission=self.admission,
                             total_pages=self.pool.total_pages,
                             spec_k=self.spec_k, clock=self.clock)

    def mesh_ranks(self) -> int:
        """The ranks of the engine's mesh (1 without one)."""
        return self.mesh.size if self.mesh is not None else 1

    def mesh_layout(self) -> str:
        """The mesh as ``"data=2"`` or ``"pod=2,data=2"``; ``""`` without
        one."""
        return self.context.mesh_layout()

    def _scope(self):
        """A tick's scope: the engine's frozen context alone, and the
        sharding context of its mesh when it has one (the Trainer's
        pattern)."""
        stack = contextlib.ExitStack()
        stack.enter_context(exctx.frozen_execution(self.context))
        if self.mesh is not None:
            stack.enter_context(rsh.use_sharding(self.mesh))
        return stack

    # -- observability ------------------------------------------------

    def _name_tracks(self) -> None:
        self.tracer.name_process(
            self.replica, f"replica {self.replica} · {self.cfg.name}")
        self.tracer.name_track(self.replica, TRACK_ENGINE, "engine")

    def _register_obs(self) -> None:
        """Register the reference's metric families into ``self.obs``, each
        a callback reading through ``self`` (so ``reset_metrics``'s swap of
        the metrics object shows, and recording costs the tick nothing).
        Re-registering replaces, so rebuilding an engine against a shared
        registry never errors."""
        reg = self.obs
        labels = {"replica": str(self.replica)}

        def counter(name, fn, help):
            reg.register_callback(name, fn, mtype="counter", help=help,
                                  labels=labels)

        def gauge(name, fn, help):
            reg.register_callback(name, fn, mtype="gauge", help=help,
                                  labels=labels)

        counter("serve_ticks_total", lambda: self.metrics.ticks,
                "engine ticks (the deterministic clock)")
        counter("serve_requests_finished_total",
                lambda: self.metrics.requests_finished,
                "requests finished (lifetime)")
        counter("serve_finished_tokens_total",
                lambda: self.metrics.finished_tokens,
                "tokens over finished requests (lifetime)")
        counter("serve_decode_steps_total",
                lambda: self.metrics.decode_steps,
                "pooled decode tick invocations")
        counter("serve_decode_tokens_total",
                lambda: self.metrics.decode_tokens,
                "tokens emitted by pooled decode ticks")
        counter("serve_prefills_total", lambda: self.metrics.prefills,
                "prompts prefilled")
        counter("serve_prefill_tokens_total",
                lambda: self.metrics.prefill_tokens,
                "prompt tokens processed (pre-padding)")
        counter("serve_chunk_ticks_total",
                lambda: self.metrics.chunk_ticks,
                "chunked-prefill pool invocations")
        counter("serve_preempted_total", lambda: self.metrics.preempted,
                "slots kicked mid-flight for pages")
        counter("serve_recompute_tokens_total",
                lambda: self.metrics.recompute_tokens,
                "already-computed tokens re-prefilled after preemption")
        counter("serve_cancelled_total", lambda: self.metrics.cancelled,
                "requests cancelled by the client")
        counter("serve_deadline_expired_total",
                lambda: self.metrics.deadline_expired,
                "requests failed on their deadline")
        counter("serve_rejected_queue_full_total",
                lambda: self.metrics.rejected_queue_full,
                "submits shed by the bounded queue")
        counter("serve_pool_exhausted_total",
                lambda: self.metrics.pool_exhausted_events,
                "admissions/growth deferred or kicked on PoolExhausted")
        counter("serve_spec_ticks_total", lambda: self.metrics.spec_ticks,
                "speculative decode pool invocations")
        counter("serve_spec_draft_tokens_total",
                lambda: self.metrics.draft_tokens,
                "draft proposals into the verify pass")
        counter("serve_spec_accepted_draft_tokens_total",
                lambda: self.metrics.accepted_draft_tokens,
                "draft proposals that survived verification")
        counter("serve_decode_time_seconds_total",
                lambda: self.metrics.decode_time_s,
                "wall seconds inside pooled decode calls")
        counter("serve_prefill_time_seconds_total",
                lambda: self.metrics.prefill_time_s,
                "wall seconds inside prefill calls")
        counter("serve_compiles_total", lambda: self.graphs.compiles,
                "graph builds through the GraphCache (warm-up + CUDA graph "
                "capture on a card, an eager call on the CPU), one per key")
        counter("serve_compile_traces_total",
                lambda: sum(self.graphs.traces.values()),
                "graph builds summed over every key (1 per key, ever)")
        counter("serve_trace_dropped_total", lambda: self.tracer.dropped,
                "trace events evicted from the bounded ring")
        gauge("serve_slots", lambda: self.slots, "decode lanes")
        gauge("serve_occupied_slots", lambda: self.occupied_slots(),
              "lanes currently holding an admitted request")
        gauge("serve_queue_depth", lambda: self.queued(),
              "requests waiting for admission")
        gauge("serve_max_concurrent_slots",
              lambda: self.metrics.max_concurrent_slots,
              "high-water mark of occupied slots")
        gauge("serve_spec_k", lambda: self.spec_k,
              "draft tokens proposed per slot tick (0 = off)")
        gauge("serve_pages_total", lambda: self.pool.total_pages,
              "physical pages incl. the trash page")
        gauge("serve_pages_in_use", lambda: self.pool.pages_in_use,
              "pages currently allocated to slots")
        gauge("serve_pages_hwm", lambda: self.pool.pages_hwm,
              "allocator high-water mark (rebased by reset_metrics)")
        gauge("serve_trace_events", lambda: len(self.tracer),
              "events currently buffered in the trace ring")
        if self.faults is not None:
            for site in FAULT_SITES:
                reg.register_callback(
                    "serve_fault_calls_total",
                    (lambda s=site: self.faults.calls.get(s, 0)),
                    mtype="counter", help="instrumented fault-site checks",
                    labels={**labels, "site": site})
                reg.register_callback(
                    "serve_fault_fired_total",
                    (lambda s=site: self.faults.fired.get(s, 0)),
                    mtype="counter", help="fault-site checks that fired",
                    labels={**labels, "site": site})

    def telemetry(self) -> Dict:
        """The registry snapshot and the metrics summary in one document
        (schema ``repro.serve/telemetry-1``)."""
        return {"schema": "repro.serve/telemetry-1",
                "summary": self.metrics.snapshot(),
                "metrics": self.obs.snapshot()}

    # -- the graph cache's entries --------------------------------------

    def _static(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _decode_entry(self) -> GraphEntry:
        key = ("decode", self.cfg.name, self.slots, self.pool.kind,
               self.sampling)
        S, i32 = self.slots, torch.int32
        return self.graphs.entry(key, lambda: (
            steps_lib.make_pool_decode_step(self.model, self._caches,
                                            self.context),
            {"tokens": self._static((S,), i32),
             "cur_pos": self._static((S,), i32),
             "active": self._static((S,), torch.bool),
             **self.pool.gather_args()}))

    def _chunk_entry(self) -> GraphEntry:
        key = ("chunk_prefill", self.cfg.name, self.slots,
               self.prefill_chunk)
        S, C, i32 = self.slots, self.prefill_chunk, torch.int32
        return self.graphs.entry(key, lambda: (
            steps_lib.make_chunk_prefill_step(self.model, self._caches,
                                              self.context),
            {"tokens": self._static((S, C), i32),
             "start_pos": self._static((S,), i32),
             "last_idx": self._static((S,), i32),
             "active": self._static((S,), torch.bool),
             "page_table": self.pool.gather_args()["page_table"]}))

    def _verify_entry(self) -> GraphEntry:
        key = ("spec_verify", self.cfg.name, self.slots, self.spec_k)
        S, K1, i32 = self.slots, self.spec_k + 1, torch.int32
        return self.graphs.entry(key, lambda: (
            steps_lib.make_spec_decode_step(self.model, self._caches,
                                            self.spec_k, self.context),
            {"tokens": self._static((S, K1), i32),
             "cur_pos": self._static((S,), i32),
             "active": self._static((S,), torch.bool),
             "page_table": self.pool.gather_args()["page_table"]}))

    def _draft_entry(self) -> GraphEntry:
        key = ("spec_draft", self.cfg.name, self.slots, self.spec_k)
        S = self.slots
        return self.graphs.entry(key, lambda: (
            steps_lib.make_draft_step(self.model, self.spec_k,
                                      self.context),
            {"anchor": self._static((S, self.cfg.d_model), torch.float32),
             "last_token": self._static((S,), torch.int32)}))

    def _run(self, entry: GraphEntry, **host: np.ndarray
             ) -> Tuple[torch.Tensor, ...]:
        """Copy ``host`` arrays and the page table into the entry's static
        inputs, then build or replay it."""
        entry.load(**host)
        if "page_table" in entry.inputs:
            self.pool.gather_args()          # refresh the device table
        return self.graphs.run(entry)

    # -- client surface ------------------------------------------------

    def submit(self, request: Request) -> Future:
        """Queue a :class:`Request`; returns a future resolving to a
        :class:`GenerationResult`. Thread-safe. Raises :class:`QueueFull`
        when ``queue_limit`` requests already wait."""
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
        self._check_extras(request.extras)
        self.pool.check_fits(self._n_front + plen + request.max_new_tokens)
        with self._lock:
            if (self.queue_limit is not None
                    and len(self._queue) >= self.queue_limit):
                self.metrics.on_queue_full()
                self.tracer.instant("shed", pid=self.replica,
                                    tid=TRACK_ENGINE, reason="queue_full",
                                    prompt_len=plen)
                raise QueueFull(self.queue_limit)
            if request.rid is None:
                rid = self._next_rid
            else:
                rid = int(request.rid)
                if self.metrics.request(rid) is not None:
                    raise ValueError(f"rid {rid} is already in flight")
            self._next_rid = max(self._next_rid, rid) + 1
            slot = _Slot(req=request, rid=rid, future=Future(),
                         prompt=np.asarray(request.prompt, np.int32))
            slot.trace_t0 = self.tracer.now()
            self.metrics.on_submit(rid, slot.prompt.size)
            self._queue.append(slot)
        return slot.future

    def _check_extras(self, extras: Optional[Mapping]) -> None:
        """Raise ``ValueError`` unless ``extras`` are exactly the inputs
        this arch's prefill reads, at their shapes: a ``vision`` arch's
        ``frontend_embeds`` (1, frontend_tokens, d_model) and an encoder
        arch's ``frames`` (1, enc_seq, d_model). Two inputs are refused
        where the reference would serve a decode that disagrees with its
        own full forward: a vision request without embeddings (its decode
        positions would count a prefix never written) and frames other
        than ``enc_seq`` rows (decode would attend to the zero rows that
        pad the cross cache)."""
        cfg, extras = self.cfg, extras or {}
        want = {}
        if cfg.frontend == "vision":
            want["frontend_embeds"] = (1, cfg.frontend_tokens, cfg.d_model)
        if cfg.n_enc_layers:
            want["frames"] = (1, cfg.enc_seq, cfg.d_model)
        for k in extras:
            if k not in want:
                raise ValueError(f"{cfg.name} takes no {k!r} in extras")
        for k, shape in want.items():
            if k not in extras:
                raise ValueError(f"{cfg.name}: a request needs extras[{k!r}]"
                                 f" {shape}")
            if extras[k].shape != shape:
                raise ValueError(f"{cfg.name}: extras[{k!r}] must be "
                                 f"{shape}, got {extras[k].shape}")

    def has_work(self) -> bool:
        with self._lock:
            queued = bool(self._queue)
        return queued or any(s is not None for s in self._slots)

    def occupied_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    def queued(self) -> int:
        with self._lock:
            return len(self._queue)

    def outstanding(self) -> int:
        """Queued + in-flight requests (thread-safe)."""
        return self.queued() + self.occupied_slots()

    def active_requests(self) -> List[int]:
        return [s.rid for s in self._slots if s is not None]

    @property
    def caches(self) -> Dict[str, torch.Tensor]:
        """The live KV caches (``"k"``/``"v"``, ``"ring_k"``/``"ring_v"``
        for ``local`` layers, state stacks for recurrent ones;
        :mod:`repro_torch.serve.cache`),
        written in place every tick."""
        return self._caches

    @property
    def compile_stats(self) -> Dict:
        """``{"compiles": entries built, "traces": {key: builds},
        "replays": {key: runs after the build}}``; per-key launches and
        capture costs are in ``self.graphs.stats()``."""
        return {"compiles": self.graphs.compiles,
                "traces": dict(self.graphs.traces),
                "replays": dict(self.graphs.replays)}

    def drain_queued(self) -> List[Tuple[_Slot, object]]:
        """Pop every not-yet-admitted request off the queue, returning
        ``(slot, record)`` pairs for :meth:`adopt` on another engine. The
        slot travels whole (a preempted request keeps its generated
        tokens). Tick thread only."""
        with self._lock:
            stolen = list(self._queue)
            self._queue.clear()
        return [(s, self.metrics.evict(s.rid)) for s in stolen]

    def adopt(self, slot: _Slot, record=None, *, front: bool = False
              ) -> None:
        """Enqueue a slot drained from another engine: same request, same
        future, same generated tokens. ``queue_limit`` does not apply (the
        request was already accepted). Thread-safe."""
        budget = int(slot.prompt.size) + slot.req.max_new_tokens
        if budget > self.max_len:
            raise ValueError(
                f"adopted request {slot.rid} needs {budget} tokens but "
                f"this engine's max_len is {self.max_len}")
        with self._lock:
            if (self.metrics.request(slot.rid) is not None
                    or any(s.rid == slot.rid for s in self._queue)):
                raise ValueError(f"rid {slot.rid} is already live on "
                                 f"this engine")
            self._next_rid = max(self._next_rid, slot.rid + 1)
            # the queue span restarts on this engine's tracer timeline
            slot.trace_t0 = self.tracer.now()
            if record is not None:
                self.metrics.adopt(record)
            else:
                self.metrics.on_submit(slot.rid, int(slot.prompt.size))
            if front:
                self._queue.appendleft(slot)
            else:
                self._queue.append(slot)

    def set_params(self, params: Union[LM, Mapping]) -> None:
        """Swap in new weights by copying them into the live parameters in
        place: the captured graphs read the parameters at their addresses,
        so rebinding them would leave the graphs on the old weights.

        ``params`` is a param tree in the reference's layout (what
        :func:`repro_torch.serve.loader.restore_params` returns), an
        :class:`LM` or its state dict. Weights only: the engine keeps its
        truncation-index buffers (checkpoints carry none), and an LM or
        state dict whose index buffers differ is refused, since its weights
        belong to another function. Refuses under live requests (a swap
        mid-flight would splice two checkpoints into one output). Safe from
        another thread: it holds the lock a tick holds."""
        if isinstance(params, torch.nn.Module):
            params = params.state_dict()
        with self._step_lock:
            if self.has_work():
                raise RuntimeError("set_params with requests queued or in "
                                   "flight — drain this engine first")
            with torch.no_grad():
                if "unit" in params:           # the reference's layout
                    convert.load_jax_params(self.model, params)
                else:
                    self._copy_weights(params)

    def _copy_weights(self, state: Mapping[str, torch.Tensor]) -> None:
        own = self.model.state_dict(keep_vars=True)
        if set(state) != set(own):
            raise KeyError(f"state dict names differ from the model's: "
                           f"{sorted(set(state) ^ set(own))}")
        for name, t in own.items():
            if not name.endswith(convert.INDEX_BUFFERS):
                t.copy_(state[name])
            elif not torch.equal(t.cpu(), state[name].cpu()):
                raise ValueError(f"{name}: the new weights' truncation "
                                 f"indices differ from the engine's; a swap "
                                 f"copies weights only")

    def abort_all(self, exc: BaseException) -> None:
        """Fail every queued and in-flight request with ``exc`` (the crash
        path for whoever drives the loop). The pool is left empty; the
        engine stays usable."""
        with self._lock:
            dead = list(self._queue)
            self._queue.clear()
            self._cancels.clear()
        for i, s in enumerate(self._slots):
            if s is not None:
                self._slots[i] = None
                self._release_slot(i)
                dead.append(s)
        self.metrics.sync_pool(self.pool)
        if dead:
            self.tracer.instant("abort", pid=self.replica,
                                tid=TRACK_ENGINE, count=len(dead),
                                error=repr(exc))
        for s in dead:
            self.metrics.evict(s.rid)
            if not s.future.done():
                s.future.set_exception(exc)

    def cancel(self, rid: int) -> bool:
        """Ask to cancel a queued or in-flight request; ``True`` when
        ``rid`` is live. Processed at the next tick boundary: the future
        resolves with :class:`RequestCancelled`, slot and pages free."""
        with self._lock:
            known = any(s.rid == rid for s in self._queue)
        known = known or any(s is not None and s.rid == rid
                             for s in self._slots)
        if not known:
            return False
        with self._lock:
            self._cancels.add(rid)
        return True

    def reset_metrics(self) -> None:
        """Fresh metrics (tick clock included), a rebased page high-water
        mark and an empty trace ring (its tracks named again), keeping the
        graphs and the pool's allocations. Only with no request in
        flight."""
        if self.has_work():
            raise RuntimeError("reset_metrics with requests in flight")
        self.pool.reset_stats()
        self.tracer.clear()
        self._name_tracks()          # clear() drops the track names
        self.metrics = self._fresh_metrics(
            history=self.metrics.max_request_history)
        self.metrics.sync_pool(self.pool)

    # -- the tick loop -------------------------------------------------

    def step(self, now: Optional[float] = None) -> int:
        """One engine tick: cancels, deadlines, admission, the
        ``engine.tick`` fault site, page growth (incremental admission),
        one prefill chunk, then one pooled decode. Returns the number of
        slots still active after the tick. ``now`` is the clock reading
        ``deadline_s`` is judged against (``clock()`` when ``None``): the
        ranks of a mesh judge against the one reading rank 0 took
        (:mod:`repro_torch.serve.mesh_serve`)."""
        with self._step_lock, self._scope():
            tick = self.metrics.ticks
            t_wall = time.monotonic()
            tt0 = self.tracer.now()
            self._process_cancels()
            self._expire_deadlines(self.clock() if now is None else now)
            self._admit()
            self.metrics.on_occupancy(self.occupied_slots())
            if self.faults is not None:
                # admissions landed, compute has not run: where a device
                # error would strand futures if the loop's abort path were
                # broken
                self.faults.check("engine.tick")
            if self.admission == "incremental":
                self._grow_pages()
            self._chunk_tick()
            if any(s is not None and s.decoding for s in self._slots):
                self._decode_tick()
            self.metrics.on_tick()
            active = self.occupied_slots()
            self.tracer.complete("tick", tt0, self.tracer.now(),
                                 pid=self.replica, tid=TRACK_ENGINE,
                                 tick=tick, active=active)
            self._tick_hist.observe(time.monotonic() - t_wall)
            return active

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

    def decode_inputs(self) -> Tuple[np.ndarray, ...]:
        """``(tokens, cur_pos, active)``, each ``(slots,)`` on the host, of
        the pooled decode tick the engine would run next."""
        tokens = np.zeros((self.slots,), np.int32)
        cur_pos = np.zeros((self.slots,), np.int32)
        active = np.zeros((self.slots,), bool)
        for i, s in enumerate(self._slots):
            if s is None or s.prefilling:
                continue
            tokens[i] = s.last_token
            cur_pos[i] = s.cur_pos
            active[i] = True
        return tokens, cur_pos, active

    def decode_logits(self, context: exctx.ContextLike = None
                      ) -> torch.Tensor:
        """Logits (slots, V) of the pooled decode tick the engine would run
        next, run eagerly under ``context`` (the engine's own when
        ``None``; :mod:`repro_torch.kernels.context`) on a copy of the KV
        pool: the engine's caches and host state are untouched."""
        if not any(s is not None and s.decoding for s in self._slots):
            raise RuntimeError("no slot is decoding")
        caches = {t: c.clone() for t, c in self._caches.items()}
        step = steps_lib.make_pool_decode_step(self.model, caches,
                                               self.context)
        tokens, cur_pos, active = (torch.from_numpy(a).to(self.device)
                                   for a in self.decode_inputs())
        return step(tokens, cur_pos, active, **self.pool.gather_args(),
                    context=context or self.context)[0]

    def replay_decode_logits(self) -> torch.Tensor:
        """Logits (slots, V) of the next pooled decode tick through the
        graph cache's decode entry (a replay once the entry is built), on
        the live KV pool, returned as a copy. The entry writes each active
        slot's K/V at ``cur_pos`` (and each inactive dense lane's at its own
        row's position 0, which admission rewrites), which the next decode
        tick writes again before any read; it advances recurrent state,
        which is copied first and put back after. So engine state is
        unchanged."""
        if not any(s is not None and s.decoding for s in self._slots):
            raise RuntimeError("no slot is decoding")
        tokens, cur_pos, active = self.decode_inputs()
        kept = {k: self._caches[k].clone()
                for k in state_keys(self._caches)}
        logits = self._run(self._decode_entry(), tokens=tokens,
                           cur_pos=cur_pos, active=active)[0].clone()
        for k, t in kept.items():
            self._caches[k].copy_(t)
        return logits

    def _spec_inputs(self) -> Tuple[np.ndarray, ...]:
        """``(last_token, cur_pos, active, anchor)`` on the host of the
        speculative tick the engine would run next: each ``(slots,)``,
        ``anchor (slots, d_model)`` float32."""
        last = np.zeros((self.slots,), np.int32)
        cur_pos = np.zeros((self.slots,), np.int32)
        active = np.zeros((self.slots,), bool)
        anchor = np.zeros((self.slots, self.cfg.d_model), np.float32)
        for i, s in enumerate(self._slots):
            if s is None or s.prefilling:
                continue
            last[i] = s.last_token
            cur_pos[i] = s.cur_pos
            active[i] = True
            anchor[i] = s.anchor
        return last, cur_pos, active, anchor

    def replay_verify_logits(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(tokens (slots, spec_k+1), logits (slots, spec_k+1, V))`` of
        the next speculative tick through the draft and verify entries
        (replays once built), on the live KV pool, returned as copies. The
        verify entry writes each active slot's K/V at ``cur_pos ..
        cur_pos+spec_k`` from the same drafts the next tick makes, so engine
        state is unchanged."""
        if not self.spec_k:
            raise RuntimeError("the engine does not speculate (spec_k=0)")
        if not any(s is not None and s.decoding for s in self._slots):
            raise RuntimeError("no slot is decoding")
        (*_, logits), _ = self._run_spec()
        return (self._verify_entry().inputs["tokens"].clone(),
                logits.clone())

    def verify_logits(self, tokens: torch.Tensor,
                      context: exctx.ContextLike = None) -> torch.Tensor:
        """Logits (slots, spec_k+1, V) of the next speculative tick's
        verify pass on ``tokens`` (slots, spec_k+1), run eagerly under
        ``context`` (the engine's own when ``None``) on a copy of the KV
        pool: the check a verify replay is held against."""
        _, cur_pos, active, _ = self._spec_inputs()
        caches = {t: c.clone() for t, c in self._caches.items()}
        step = steps_lib.make_spec_decode_step(self.model, caches,
                                               self.spec_k, self.context)
        return step(tokens.to(self.device),
                    torch.from_numpy(cur_pos).to(self.device),
                    torch.from_numpy(active).to(self.device),
                    self.pool.gather_args()["page_table"],
                    context=context or self.context)[3]

    # -- internals -----------------------------------------------------

    def _run_spec(self) -> Tuple[Tuple[torch.Tensor, ...], float]:
        """The draft entry, then the verify entry on its drafts: the
        verify's ``(targets, accepted, anchor, logits)``, and the tracer's
        time between the two launches."""
        last, cur_pos, active, anchor = self._spec_inputs()
        (drafts,) = self._run(self._draft_entry(), anchor=anchor,
                              last_token=last)
        ttd = self.tracer.now()
        verify = self._verify_entry()
        verify.inputs["tokens"][:, 1:].copy_(drafts)
        verify.inputs["tokens"][:, 0].copy_(torch.from_numpy(last))
        return self._run(verify, cur_pos=cur_pos, active=active), ttd

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
            budget = self._n_front + int(slot.prefill_seq.size)
            if self.admission == "eager":
                budget += slot.req.max_new_tokens
            try:
                self.pool.alloc_pages(idx, budget)
            except PoolExhausted:
                # keep FIFO order: the head request waits for pages
                self.metrics.on_pool_exhausted()
                return
            with self._lock:
                self._queue.popleft()
            self.metrics.sync_pool(self.pool)
            self.metrics.on_admit(slot.rid)
            tid, tnow = slot.rid + 1, self.tracer.now()
            self.tracer.name_track(self.replica, tid, f"req {slot.rid}")
            self.tracer.complete("queue", slot.trace_t0, tnow,
                                 pid=self.replica, tid=tid, rid=slot.rid,
                                 resume=bool(slot.tokens))
            self.tracer.instant("admit", pid=self.replica, tid=tid, ts=tnow,
                                rid=slot.rid, slot=idx,
                                tick=self.metrics.ticks)
            slot.admit_seq = self._admit_seq
            self._admit_seq += 1
            if self.prefill_chunk is None:
                self._admit_bucketed(slot, idx)
                continue
            slot.prefilled = 0
            self._slots[idx] = slot

    def bucket_for(self, prompt_len: int) -> int:
        """Whole-prompt prefill bucket: the next power of two (>=
        ``min_bucket``, <= ``max_len``), or the exact length for archs in
        :data:`SEQUENTIAL_STATE_BLOCKS`, whose padded prefill would corrupt
        their state or rings."""
        if self._exact_buckets:
            return prompt_len
        b = self.min_bucket
        while b < prompt_len:
            b *= 2
        return min(b, self.max_len)

    def _admit_bucketed(self, slot: _Slot, idx: int) -> None:
        """Whole-prompt admission: right-pad ``prefill_seq`` (the prompt,
        or prompt + generated tokens after a preemption: the recompute) to
        its bucket, prefill it at batch 1 with the request's ``extras`` into
        a fresh dense cache tree, splice the tree into the slot, sample the
        first token. Eager: each bucket's launches count as the kernels'
        counters count them."""
        # the slot owns the lane before its prefill runs, so that a prefill
        # that raises leaves the request to abort_all, not stranded
        self._slots[idx] = slot
        plen = int(slot.prefill_seq.size)
        bucket = self.bucket_for(plen)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :plen] = slot.prefill_seq
        step = steps_lib.make_bucket_prefill_step(self.model, self.max_len,
                                                  self.context)
        extras = {k: torch.from_numpy(v).to(self.device)
                  for k, v in (slot.req.extras or {}).items()}
        t0 = time.monotonic()
        tt0 = self.tracer.now()
        logits, sub = step(torch.from_numpy(tokens).to(self.device),
                           torch.tensor([plen - 1], dtype=torch.int32,
                                        device=self.device), **extras)
        self.pool.write_slot(self._caches, sub, idx)
        del sub
        tok = int(self._sample_fn(logits, self._gen)[0])
        self.metrics.on_prefill_work(plen, time.monotonic() - t0)
        self.tracer.complete("prefill", tt0, self.tracer.now(),
                             pid=self.replica, tid=slot.rid + 1,
                             rid=slot.rid, bucket=bucket, tokens=plen,
                             recompute=bool(slot.tokens))
        if slot.tokens:
            # resumed after preemption: the recomputed prefix ends in
            # generated tokens, so this is the NEXT token, and the
            # request's one real prefill was already counted
            self.metrics.on_token(slot.rid)
        else:
            self.metrics.on_prefill_done()
            self.metrics.on_first_token(slot.rid)
            self.tracer.instant("first_token", pid=self.replica,
                                tid=slot.rid + 1, rid=slot.rid,
                                tick=self.metrics.ticks)
        slot.tokens.append(tok)
        slot.last_token = tok
        slot.cur_pos = self._n_front + plen
        slot.prefilled = -1                  # decode phase
        if self._finished(slot):
            self._finish(idx)

    # -- lifecycle: cancel / deadline / preempt -------------------------

    def _resolve_dead(self, dead: List[Tuple[_Slot, BaseException]],
                      on_record: Callable[[int], None]) -> None:
        for s, exc in dead:
            on_record(s.rid)
            if not s.future.done():
                s.future.set_exception(exc)

    def _process_cancels(self) -> None:
        with self._lock:
            if not self._cancels:
                return
            rids, self._cancels = self._cancels, set()
            hit = [s for s in self._queue if s.rid in rids]
            for s in hit:
                self._queue.remove(s)
        for i, s in enumerate(self._slots):
            if s is not None and s.rid in rids:
                self._slots[i] = None
                self._release_slot(i)
                hit.append(s)
        if hit:
            self.metrics.sync_pool(self.pool)
        for s in hit:
            self.tracer.instant("cancel", pid=self.replica, tid=s.rid + 1,
                                rid=s.rid, tick=self.metrics.ticks)
        self._resolve_dead([(s, RequestCancelled(s.rid)) for s in hit],
                           self.metrics.on_cancel)

    def _deadline_reason(self, slot: _Slot, now: float) -> Optional[str]:
        req = slot.req
        if req.deadline_ticks is None and req.deadline_s is None:
            return None
        rm = self.metrics.request(slot.rid)
        if rm is None:
            return None
        if req.deadline_ticks is not None:
            waited = self.metrics.ticks - rm.submit_tick
            if waited >= req.deadline_ticks:
                return (f"{waited} ticks since submit >= deadline_ticks="
                        f"{req.deadline_ticks}")
        if req.deadline_s is not None:
            waited_s = now - rm.submit_t
            if waited_s >= req.deadline_s:
                return (f"{waited_s:.3f}s since submit >= deadline_s="
                        f"{req.deadline_s}")
        return None

    def _expire_deadlines(self, now: float) -> None:
        with self._lock:
            expired = [(s, self._deadline_reason(s, now))
                       for s in self._queue]
            expired = [(s, r) for s, r in expired if r is not None]
            for s, _ in expired:
                self._queue.remove(s)
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            r = self._deadline_reason(s, now)
            if r is not None:
                self._slots[i] = None
                self._release_slot(i)
                expired.append((s, r))
        if expired:
            self.metrics.sync_pool(self.pool)
        for s, r in expired:
            self.tracer.instant("deadline", pid=self.replica, tid=s.rid + 1,
                                rid=s.rid, reason=r, tick=self.metrics.ticks)
        self._resolve_dead(
            [(s, DeadlineExceeded(s.rid, r)) for s, r in expired],
            self.metrics.on_deadline)

    def _preempt(self, idx: int) -> None:
        """Kick slot ``idx`` for pages: free them and requeue the request
        at the queue head with its generated tokens appended to the
        prompt; re-admission recomputes the prefix through chunked
        prefill."""
        s = self._slots[idx]
        self._slots[idx] = None
        self._release_slot(idx)
        computed = (s.prefilled if s.prefilling
                    else int(s.prompt.size) + len(s.tokens))
        if s.tokens:
            s.prefill_seq = np.concatenate(
                [s.prompt, np.asarray(s.tokens, np.int32)])
        else:
            s.prefill_seq = s.prompt
        s.prefilled = -1
        s.cur_pos = 0
        s.last_token = -1
        s.anchor = None              # the recompute's final chunk re-derives
        self.metrics.on_preempt(s.rid, computed)
        self.tracer.instant("preempt", pid=self.replica, tid=s.rid + 1,
                            rid=s.rid, computed=computed,
                            tick=self.metrics.ticks)
        s.trace_t0 = self.tracer.now()   # back in the queue: a new span
        with self._lock:
            self._queue.appendleft(s)

    def _grow_pages(self) -> None:
        """Incremental admission: grow every live slot's pages to cover
        this tick's writes, oldest slot first; on :class:`PoolExhausted`
        preempt the youngest slot and retry (the growing slot may preempt
        itself). Terminates: every preemption frees pages, and ``submit``
        rejected any request whose budget could never fit."""
        C = self.prefill_chunk
        order = sorted(
            (i for i, s in enumerate(self._slots) if s is not None),
            key=lambda i: self._slots[i].admit_seq)
        tt0 = self.tracer.now()
        for i in order:
            s = self._slots[i]
            if s is None:                  # preempted as a younger victim
                continue
            # a speculative tick writes spec_k draft positions past the
            # committed one; never grow past the request's own budget
            # (writes beyond it go to the trash page)
            budget = self._n_front + int(s.prompt.size) + s.req.max_new_tokens
            if s.prefilling:
                end = min(s.prefilled + C, int(s.prefill_seq.size))
                need = self._n_front + end
                if end == s.prefill_seq.size:
                    # the final chunk lands: this tick's decode writes too
                    need = min(need + 1 + self.spec_k, budget)
            else:
                need = min(s.cur_pos + 1 + self.spec_k, budget)
            while True:
                try:
                    self.pool.alloc_pages(i, need)
                    break
                except PoolExhausted:
                    self.metrics.on_pool_exhausted()
                    victim = max(
                        (j for j, v in enumerate(self._slots)
                         if v is not None),
                        key=lambda j: self._slots[j].admit_seq)
                    self._preempt(victim)
                    if victim == i:
                        break              # kicked ourselves
        self.metrics.sync_pool(self.pool)
        if order:
            self.tracer.complete("grow_pages", tt0, self.tracer.now(),
                                 pid=self.replica, tid=TRACK_ENGINE,
                                 tick=self.metrics.ticks,
                                 pages_in_use=self.pool.pages_in_use)

    def _chunk_tick(self) -> None:
        """Advance every prefilling slot by one chunk (one pooled step);
        slots whose final chunk lands sample their next token."""
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
            hi = min(lo + C, int(s.prefill_seq.size))
            tokens[i, :hi - lo] = s.prefill_seq[lo:hi]
            start[i] = lo
            last[i] = hi - lo - 1
            active[i] = True
            spans[i] = (lo, hi)
        entry = self._chunk_entry()
        build = not self.graphs.built(entry)
        t0 = time.monotonic()
        tt0 = self.tracer.now()
        logits, h_last = self._run(entry, tokens=tokens, start_pos=start,
                                   last_idx=last, active=active)
        tt1 = self.tracer.now()
        real = sum(hi - lo for lo, hi in spans.values())
        self.tracer.complete("prefill_chunk", tt0, tt1, pid=self.replica,
                             tid=TRACK_ENGINE, slots=len(live), tokens=real,
                             tick=self.metrics.ticks)
        for i, s in live:
            lo, hi = spans[i]
            self.tracer.complete(f"prefill_chunk[{lo // C}]", tt0, tt1,
                                 pid=self.replica, tid=s.rid + 1, rid=s.rid,
                                 lo=lo, hi=hi, recompute=bool(s.tokens))
        done = [i for i, s in live if spans[i][1] == s.prefill_seq.size]
        first, anchors = {}, None
        if done:
            rows = torch.tensor(done, device=self.device)
            toks = self._sample_fn(logits[rows], self._gen)
            first = dict(zip(done, toks.cpu().tolist()))
            if self.spec_k:
                anchors = h_last.float().cpu().numpy()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.metrics.on_prefill_work(real, time.monotonic() - t0,
                                     chunked=True, build=build)
        finishers = []
        for i, s in live:
            s.prefilled = spans[i][1]
            if i not in first:
                continue
            if s.tokens:
                # resumed after preemption: the recomputed prefix ends in
                # generated tokens, so this is the NEXT token, and the
                # request's one real prefill was already counted
                self.metrics.on_token(s.rid)
            else:
                self.metrics.on_prefill_done()
                self.metrics.on_first_token(s.rid)
                self.tracer.instant("first_token", pid=self.replica,
                                    tid=s.rid + 1, rid=s.rid,
                                    tick=self.metrics.ticks)
            s.tokens.append(int(first[i]))
            s.last_token = int(first[i])
            s.cur_pos = self._n_front + int(s.prefill_seq.size)
            s.prefilled = -1                # decode phase
            if anchors is not None:
                s.anchor = anchors[i]
            if self._finished(s):
                finishers.append(i)
        for i in finishers:
            self._finish(i)

    def _decode_tick(self) -> None:
        if self.spec_k:
            return self._spec_decode_tick()
        tokens, cur_pos, active = self.decode_inputs()
        entry = self._decode_entry()
        build = not self.graphs.built(entry)
        t0 = time.monotonic()
        tt0 = self.tracer.now()
        (logits,) = self._run(entry, tokens=tokens, cur_pos=cur_pos,
                              active=active)
        nxt = self._sample_fn(logits, self._gen).cpu().tolist()
        tt1 = self.tracer.now()       # after the read: device time inside
        n_active = int(active.sum())
        self.metrics.on_decode_tick(n_active, n_active,
                                    time.monotonic() - t0, build=build)
        self.tracer.complete("decode", tt0, tt1, pid=self.replica,
                             tid=TRACK_ENGINE, active=n_active,
                             tick=self.metrics.ticks)
        for i, s in enumerate(self._slots):
            if s is None or s.prefilling:
                continue
            s.tokens.append(int(nxt[i]))
            s.last_token = int(nxt[i])
            s.cur_pos += 1
            self.metrics.on_token(s.rid)
            self.tracer.complete("decode", tt0, tt1, pid=self.replica,
                                 tid=s.rid + 1, rid=s.rid, token=int(nxt[i]),
                                 pos=s.cur_pos)
            if self._finished(s):
                self._finish(i)

    def _spec_decode_tick(self) -> None:
        """Draft-k-verify-1: the draft entry proposes ``spec_k`` tokens per
        slot from each slot's anchor, the verify entry checks every
        position in one batched pass, and each slot commits its accepted
        prefix. The committed tokens are the verify pass's own greedy
        targets, so acceptance decides how many land per tick, never which.
        A commit cut short (budget or stop token) finishes the slot, so the
        verify anchor, valid only for full commits, is never used stale."""
        live = [(i, s) for i, s in enumerate(self._slots)
                if s is not None and s.decoding]
        if not live:
            return
        build = not (self.graphs.built(self._draft_entry())
                     and self.graphs.built(self._verify_entry()))
        t0 = time.monotonic()
        tt0 = self.tracer.now()
        (targets, accepted, anchor_out, _), ttd = self._run_spec()
        tt1 = self.tracer.now()       # before the reads, as the reference
        self.tracer.complete("spec_draft", tt0, ttd, pid=self.replica,
                             tid=TRACK_ENGINE, slots=len(live),
                             tick=self.metrics.ticks)
        self.tracer.complete("spec_verify", ttd, tt1, pid=self.replica,
                             tid=TRACK_ENGINE, slots=len(live),
                             tick=self.metrics.ticks)
        targets = targets.cpu().numpy()
        accepted = accepted.cpu().numpy()
        anchor_out = anchor_out.float().cpu().numpy()
        committed_total = 0
        for i, s in live:
            m = min(int(accepted[i]) + 1,
                    s.req.max_new_tokens - len(s.tokens))
            toks = [int(t) for t in targets[i, :m]]
            stop = s.req.stop_token
            if stop is not None and stop in toks:
                toks = toks[:toks.index(stop) + 1]
            s.tokens.extend(toks)
            s.last_token = toks[-1]
            s.cur_pos += len(toks)
            s.anchor = anchor_out[i]
            committed_total += len(toks)
            self.metrics.on_token(s.rid, len(toks))
            self.tracer.complete("spec", tt0, tt1, pid=self.replica,
                                 tid=s.rid + 1, rid=s.rid,
                                 drafted=self.spec_k,
                                 accepted=int(accepted[i]),
                                 committed=len(toks))
        self.metrics.on_spec_tick(
            drafted=len(live) * self.spec_k,
            accepted=int(accepted[[i for i, _ in live]].sum()))
        self.metrics.on_decode_tick(len(live), committed_total,
                                    time.monotonic() - t0, build=build)
        for i, s in live:
            if self._finished(s):
                self._finish(i)

    def _finished(self, slot: _Slot) -> bool:
        if len(slot.tokens) >= slot.req.max_new_tokens:
            return True
        stop = slot.req.stop_token
        return stop is not None and slot.last_token == stop

    def _release_slot(self, idx: int) -> None:
        """The one scrub-then-free tail of every slot exit (finish, cancel,
        deadline, preempt, abort): under ``scrub_freed_slots`` the slot's
        pages, rings and rows are zeroed BEFORE ``pool.free()``, which
        sends its table row to the trash page (a later scrub would zero the
        trash page and leave the request's KV in recycled pages)."""
        if self.scrub_freed_slots:
            self.pool.reset_slot(self._caches, idx)
        self.pool.free(idx)

    def _finish(self, idx: int) -> None:
        slot = self._slots[idx]
        self._slots[idx] = None
        rm = self.metrics.on_finish(slot.rid)
        self._release_slot(idx)
        self.metrics.sync_pool(self.pool)
        self.tracer.instant("finish", pid=self.replica, tid=slot.rid + 1,
                            rid=slot.rid, new_tokens=len(slot.tokens),
                            tick=self.metrics.ticks)
        slot.future.set_result(GenerationResult(
            rid=slot.rid, prompt=slot.prompt, tokens=list(slot.tokens),
            metrics=rm))

"""CUDA graphs of the serving engine's ticks: the port's counterpart of the
reference's ``CompileCache`` (``repro.serve.engine``).

The reference pays its dispatch once per tick, through ``jax.jit``; an
eager PyTorch tick pays it once per launch, thousands of times. A
:class:`GraphCache` holds one entry per key, like the reference's
compile keys (``("decode", arch, slots, sampling)``, ``("chunk_prefill",
arch, slots, chunk)``, ``("spec_verify", arch, slots, k)``,
``("spec_draft", arch, slots, k)``). An entry is a step function of
fixed-shape tensors (:mod:`repro_torch.serve.steps`) with its static
input tensors, which the entry owns: the engine copies each tick's host
state into them, runs the entry, and reads its outputs.

* **On CUDA** the first run of an entry is its build: the step runs
  eagerly on the cache's capture stream (the warm-up, which builds the
  kernels on their first call and is this tick's own computation), then
  one ``torch.cuda.CUDAGraph`` capture of it. Every later run is a replay
  of that graph. All graphs share one memory pool
  (``torch.cuda.graph_pool_handle()``), which is safe because the engine
  runs them one at a time and reads each one's outputs before the next
  runs: an entry's outputs hold only until the next run of any entry. A
  capture that fails raises, naming the key; nothing carries on eagerly.
* **On the CPU** a build and a replay are eager calls of the step, and the
  same counters are kept, so tests can hold "one build per key". A cache
  made with ``capture=False`` runs its entries so on a card too: an
  engine on a mesh of more than one rank, whose ticks issue gloo
  collectives, which a CUDA graph cannot capture.

Every build is a structured event, as the reference's cold compiles are:
it appends ``{"key": format_key(key), "seconds": …}`` to
:attr:`GraphCache.events` (warm-up + capture on CUDA, the eager call on
the CPU) and emits one ``compile`` complete-span on the engine lane of the
``tracer`` the engine passes in (``pid`` = its replica).

Captures run with ``capture_error_mode="thread_local"``: another thread's
CUDA work (a router's caller copying a checkpoint in while one replica
captures) does not invalidate the capture. The engine serialises its own
weight copies against its ticks with a lock (``ServeEngine.set_params``).

The kernel wrappers count launches in Python, which runs when a graph is
captured and not when it is replayed. So a capture records the growth of
each counter in :data:`COUNTED`, takes it back (a capture launches
nothing), and every replay adds it again: the counters keep meaning
kernel launches on the card.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sandwich as ks
from repro_torch.obs.tracing import NULL_TRACER, TRACK_ENGINE

# the captures holding Python's collector off (:meth:`GraphCache._gc_paused`)
_GC_LOCK = threading.Lock()
_GC_PAUSES = 0

#: the launch counters a replay advances, by the name chip_smoke.py prints
COUNTED = (("sandwich_fwd", ks.sandwich_forward),
           ("paged_decode_attention", pa.paged_decode_attention))


@dataclass
class GraphEntry:
    """One key's step, its static inputs and, once built, its graph and
    static outputs."""

    key: Tuple
    fn: Callable[..., Tuple[torch.Tensor, ...]]
    inputs: Dict[str, torch.Tensor]
    graph: Optional[object] = None               # torch.cuda.CUDAGraph
    outputs: Tuple[torch.Tensor, ...] = ()
    launches: Dict[str, int] = field(default_factory=dict)  # per replay
    warmup_s: float = 0.0
    capture_s: float = 0.0

    def load(self, **arrays: np.ndarray) -> None:
        """Copy host arrays into the static inputs of the same names."""
        for name, a in arrays.items():
            self.inputs[name].copy_(torch.from_numpy(a))


class GraphCache:
    """Entries by key, with ``traces`` (builds per key: 1, ever) and
    ``replays`` (runs after the build) counters, and ``events`` (one
    ``{"key", "seconds"}`` per build)."""

    def __init__(self, device: torch.device, tracer=None, pid: int = 0,
                 capture: bool = True):
        self.device = torch.device(device)
        self._entries: Dict[Tuple, GraphEntry] = {}
        self.traces: Dict[Tuple, int] = {}
        self.replays: Dict[Tuple, int] = {}
        self.events: List[Dict] = []
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self._pid = int(pid)
        self._cuda = self.device.type == "cuda"
        #: whether builds capture CUDA graphs (on a card, unless refused)
        self.captures = self._cuda and capture
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._pool = torch.cuda.graph_pool_handle() if self._cuda else None

    def built(self, e: GraphEntry) -> bool:
        """Whether ``e`` was built: its next :meth:`run` is a replay."""
        return e.key in self.traces

    def entry(self, key: Tuple, build: Callable[[], Tuple[Callable, Dict]]
              ) -> GraphEntry:
        """The entry of ``key``; ``build() -> (fn, inputs)`` makes it the
        first time."""
        e = self._entries.get(key)
        if e is None:
            fn, inputs = build()
            e = self._entries[key] = GraphEntry(key, fn, inputs)
        return e

    def run(self, e: GraphEntry) -> Tuple[torch.Tensor, ...]:
        """Run ``e`` on its static inputs: build it (the first time) or
        replay it. Returns its outputs."""
        if e.key not in self.traces:
            t0 = time.monotonic()
            tt0 = self._tracer.now()
            out = self._capture(e) if self.captures else e.fn(**e.inputs)
            self.traces[e.key] = 1
            self.replays[e.key] = 0
            key, dt = format_key(e.key), round(time.monotonic() - t0, 6)
            self.events.append({"key": key, "seconds": dt})
            self._tracer.complete("compile", tt0, self._tracer.now(),
                                  pid=self._pid, tid=TRACK_ENGINE,
                                  cat="compile", key=key, seconds=dt)
            return out
        self.replays[e.key] += 1
        if not self.captures:
            return e.fn(**e.inputs)
        e.graph.replay()
        for name, counter in COUNTED:
            counter.launches += e.launches[name]
        return e.outputs

    @staticmethod
    @contextlib.contextmanager
    def _gc_paused():
        """Python's collector held off while a capture runs: a collection
        there can free an older engine's graphs, whose destruction is not
        permitted while a stream captures and invalidates the capture
        (``torch.cuda.graph`` collects once before it begins). Captures on
        several threads share one count."""
        with _GC_LOCK:
            global _GC_PAUSES
            if _GC_PAUSES == 0 and gc.isenabled():
                gc.disable()
                _GC_PAUSES = 1
            elif _GC_PAUSES:
                _GC_PAUSES += 1
        try:
            yield
        finally:
            with _GC_LOCK:
                if _GC_PAUSES:
                    _GC_PAUSES -= 1
                    if _GC_PAUSES == 0:
                        gc.enable()

    def _capture(self, e: GraphEntry) -> Tuple[torch.Tensor, ...]:
        dev, s = self.device, self._stream
        t0 = time.monotonic()
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            out = e.fn(**e.inputs)
        torch.cuda.current_stream(dev).wait_stream(s)
        torch.cuda.synchronize(dev)
        t1 = time.monotonic()
        before = {name: c.launches for name, c in COUNTED}
        graph = torch.cuda.CUDAGraph()
        try:
            with self._gc_paused(), torch.cuda.graph(
                    graph, pool=self._pool, stream=s,
                    capture_error_mode="thread_local"):
                outputs = e.fn(**e.inputs)
        except Exception as exc:
            raise RuntimeError(f"CUDA graph capture of {format_key(e.key)} "
                               f"failed: {exc}") from exc
        finally:
            launched = {name: c.launches - before[name]
                        for name, c in COUNTED}
            for name, c in COUNTED:
                c.launches = before[name]
        e.graph, e.outputs, e.launches = graph, outputs, launched
        e.warmup_s, e.capture_s = t1 - t0, time.monotonic() - t1
        return out

    @property
    def compiles(self) -> int:
        return len(self.traces)

    def pool_bytes(self) -> Optional[int]:
        """Device memory the allocator holds in the graphs' shared pool: the
        sum of its segments in ``torch.cuda.memory_snapshot()``; 0 on the
        CPU, ``None`` where the snapshot does not name each segment's
        pool."""
        if not self._cuda:
            return 0
        segments = torch.cuda.memory_snapshot()
        if any("segment_pool_id" not in s for s in segments):
            return None
        pool = tuple(self._pool)
        return sum(s["total_size"] for s in segments
                   if tuple(s["segment_pool_id"]) == pool)

    def stats(self) -> Dict[str, Dict]:
        """Per built key (formatted): captures, replays, kernel launches
        per replay, warm-up and capture seconds (the last two 0 on the
        CPU)."""
        out = {}
        for key in self.traces:
            e = self._entries[key]
            out[format_key(key)] = {
                "captures": self.traces[key], "replays": self.replays[key],
                "launches_per_replay": dict(e.launches),
                "warmup_s": e.warmup_s, "capture_s": e.capture_s}
        return out


def format_key(key: Tuple) -> str:
    return " | ".join(str(k) for k in key)

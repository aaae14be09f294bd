"""Failure detection and straggler accounting.

Copies of ``HeartbeatMonitor``, ``StragglerMonitor`` and
``MitigationAction`` from ``repro.runtime.fault_tolerance``: a heartbeat
watchdog (the serving client's wedge detector) and EMA step-time tracking
per worker with the rebalance/evict policy. The rest of that module
(elastic meshes) is not ported.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


class HeartbeatMonitor:
    """Failure detection: workers ``ping``; a watchdog thread marks a
    worker dead after ``timeout`` seconds of silence and calls
    ``on_failure(worker)`` once. The serving client registers its driver
    thread as a worker, so a wedged tick is detected
    (:class:`repro_torch.serve.client.TickDriver`)."""

    def __init__(self, workers: Sequence[str], timeout: float = 1.0,
                 on_failure: Optional[Callable[[str], None]] = None,
                 poll: float = 0.05):
        self.timeout = timeout
        self.on_failure = on_failure
        self.poll = poll
        now = time.monotonic()
        self._last: Dict[str, float] = {w: now for w in workers}
        self._dead: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def ping(self, worker: str) -> None:
        with self._lock:
            if worker not in self._dead:
                self._last[worker] = time.monotonic()

    def _watch(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            newly_dead = []
            with self._lock:
                for w, t in self._last.items():
                    if w not in self._dead and now - t > self.timeout:
                        self._dead.add(w)
                        newly_dead.append(w)
            for w in newly_dead:
                if self.on_failure:
                    self.on_failure(w)
            time.sleep(self.poll)

    @property
    def dead(self) -> List[str]:
        with self._lock:
            return sorted(self._dead)

    @property
    def alive(self) -> List[str]:
        with self._lock:
            return sorted(set(self._last) - self._dead)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)

    def __enter__(self) -> "HeartbeatMonitor":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


@dataclass
class MitigationAction:
    kind: str                      # "none" | "rebalance" | "evict"
    worker: str = ""
    microbatch_weights: Optional[Dict[str, float]] = None


class StragglerMonitor:
    """EMA step-time tracking + mitigation policy.

    ``threshold``: relative slowdown vs the median EMA that flags a
    straggler. ``patience``: consecutive flagged steps before eviction is
    recommended (transient slowdowns only trigger rebalancing).
    """

    def __init__(self, workers: Sequence[str], alpha: float = 0.3,
                 threshold: float = 1.5, patience: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.ema: Dict[str, float] = {w: 0.0 for w in workers}
        self.flags: Dict[str, int] = {w: 0 for w in workers}

    def record(self, step_times: Dict[str, float]) -> MitigationAction:
        for w, t in step_times.items():
            prev = self.ema.get(w, 0.0)
            self.ema[w] = t if prev == 0.0 else \
                self.alpha * t + (1 - self.alpha) * prev
        med = float(np.median(list(self.ema.values())))
        worst = max(self.ema, key=self.ema.get)
        if med <= 0 or self.ema[worst] <= self.threshold * med:
            for w in self.flags:
                self.flags[w] = 0
            return MitigationAction("none")
        self.flags[worst] += 1
        for w in self.flags:
            if w != worst:
                self.flags[w] = 0
        if self.flags[worst] >= self.patience:
            return MitigationAction("evict", worker=worst)
        # rebalance: shift work away proportionally to EMA speed
        inv = {w: 1.0 / max(e, 1e-9) for w, e in self.ema.items()}
        z = sum(inv.values())
        weights = {w: v / z for w, v in inv.items()}
        return MitigationAction("rebalance", worker=worst,
                                microbatch_weights=weights)

"""Straggler accounting for the trainer.

A copy of ``StragglerMonitor`` and ``MitigationAction`` from
``repro.runtime.fault_tolerance``: EMA step-time tracking per worker and
the rebalance/evict policy. The rest of that module (heartbeats, elastic
meshes) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np


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

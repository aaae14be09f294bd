"""Deterministic fault injection for the serving stack.

A copy of ``repro.serve.faults`` for the port: numpy and ``os`` only, the
same sites, schedules, exception types and checkpoint damage.

Every recovery path the engine claims to have — preemption on page
exhaustion, the client's abort-on-crash sweep, torn-checkpoint restore
fallback — must be *exercisable on demand* or it is folklore. A
:class:`FaultInjector` is a seeded schedule of forced failures threaded
through the engine and the page pool: the same seed and the same call
sequence fire the same faults, so a test that provokes a preemption storm
or a mid-tick crash replays bit-identically.

Sites (where a ``check(site)`` call is instrumented):

=================  ========================================================
``pool.alloc``     :meth:`PagedCachePool.alloc_pages` — fires a forced
                   :class:`~repro_torch.serve.cache.PoolExhausted` even
                   when free pages exist. Under eager admission this defers the
                   admission (backpressure); under incremental admission it
                   drives the preemption/recompute path.
``engine.tick``    :meth:`ServeEngine.step`, after admission but before the
                   compute ticks — a mid-tick crash
                   (:class:`InjectedFault`). Whoever drives the loop must
                   fail outstanding futures instead of stranding them
                   (:meth:`ServeEngine.abort_all`).
=================  ========================================================

Faults fire either at explicit call ordinals (``at={"pool.alloc": (3, 7)}``
fires the 3rd and 7th allocation) or as a seeded Bernoulli stream
(``rates={"pool.alloc": 0.1}``); both compose. ``calls`` / ``fired``
counters expose the schedule a run actually took.

Torn checkpoints are a *filesystem* fault, so they are injected by
:func:`tear_checkpoint` — it damages the newest on-disk checkpoint the way
a killed writer would (sentinel missing, or committed-but-garbage arrays)
and the restore path must fall back to the newest older valid step.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Iterable, Mapping, Optional

import numpy as np

from repro_torch.serve.cache import PoolExhausted

#: the instrumented sites a schedule may name (typo'd site names in a
#: schedule raise at construction instead of silently never firing)
SITES = ("pool.alloc", "engine.tick")


class InjectedFault(RuntimeError):
    """A scheduled fault modeling a crash (not backpressure): the engine
    does not catch it — the tick loop's abort path must. Carries the site and
    call ordinal so a test can assert exactly which scheduled fault it
    observed."""

    def __init__(self, site: str, ordinal: int):
        super().__init__(f"injected fault at {site!r} (call #{ordinal})")
        self.site = site
        self.ordinal = ordinal


class FaultInjector:
    """Seeded, reproducible fault schedule.

    * ``at`` — per-site explicit 1-based call ordinals that always fire.
    * ``rates`` — per-site Bernoulli fire probability, drawn from one
      ``numpy`` Generator seeded with ``seed``: deterministic given the
      seed and the call order (which the engine's single-threaded tick
      loop makes deterministic).
    * ``check(site)`` — instrumented code calls this; it raises the
      site's exception type when the schedule says so
      (:class:`PoolExhausted` for ``pool.alloc``, :class:`InjectedFault`
      otherwise) and returns quietly when it does not.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Mapping[str, float]] = None,
                 at: Optional[Mapping[str, Iterable[int]]] = None):
        self.seed = int(seed)
        self.rates: Dict[str, float] = dict(rates or {})
        self.at: Dict[str, frozenset] = {
            site: frozenset(int(n) for n in ordinals)
            for site, ordinals in (at or {}).items()}
        for site in (*self.rates, *self.at):
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r}: expected one of {SITES}")
        for site, p in self.rates.items():
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"rate for {site!r} must be in [0, 1], "
                                 f"got {p}")
        self._rng = np.random.default_rng(self.seed)
        self.calls: collections.Counter = collections.Counter()
        self.fired: collections.Counter = collections.Counter()

    def check(self, site: str) -> None:
        """Raise the site's fault if the schedule fires at this call."""
        self.calls[site] += 1
        n = self.calls[site]
        fire = n in self.at.get(site, ())
        rate = self.rates.get(site, 0.0)
        if rate > 0.0:
            # draw even when an explicit ordinal already fired, so the
            # stream position depends only on the call sequence
            fire = bool(self._rng.random() < rate) or fire
        if not fire:
            return
        self.fired[site] += 1
        if site == "pool.alloc":
            raise PoolExhausted(
                f"injected exhaustion at pool.alloc call #{n} "
                f"(seed={self.seed})")
        raise InjectedFault(site, n)

    def summary(self) -> Dict[str, Dict[str, int]]:
        """Plain-JSON ``{site: {calls, fired}}`` for metrics/CLI output."""
        return {site: {"calls": int(self.calls.get(site, 0)),
                       "fired": int(self.fired.get(site, 0))}
                for site in SITES
                if self.calls.get(site) or self.fired.get(site)}


# ---------------------------------------------------------------------------
# Filesystem faults: torn / corrupt checkpoints
# ---------------------------------------------------------------------------

def tear_checkpoint(checkpoint_dir: str, mode: str = "torn") -> str:
    """Damage the newest checkpoint under ``checkpoint_dir`` the way a
    killed writer would, and return the damaged step directory.

    * ``mode="torn"`` — remove the ``_COMMITTED`` sentinel: data present,
      commit missing (the writer died between array write and commit).
    * ``mode="corrupt"`` — keep the sentinel but overwrite ``arrays.npz``
      with garbage (committed, then the disk lied).

    Either way, :func:`repro_torch.checkpoint.checkpointing.load_latest`
    must skip the damaged step and fall back to the newest older valid
    one.
    """
    steps = sorted(
        name for name in os.listdir(checkpoint_dir)
        if name.startswith("step_")
        and os.path.isdir(os.path.join(checkpoint_dir, name)))
    if not steps:
        raise FileNotFoundError(
            f"no step_* checkpoints under {checkpoint_dir!r}")
    target = os.path.join(checkpoint_dir, steps[-1])
    sentinel = os.path.join(target, "_COMMITTED")
    if mode == "torn":
        if os.path.exists(sentinel):
            os.remove(sentinel)
    elif mode == "corrupt":
        with open(os.path.join(target, "arrays.npz"), "wb") as f:
            f.write(b"not an npz \x00 torn mid-write")
    else:
        raise ValueError(f"unknown tear mode {mode!r}: expected 'torn' or "
                         f"'corrupt'")
    return target

"""Seeded load generation for the serving tier.

The port's copy of ``repro.serve.trace`` (numpy only). The trace-replay
CLI (``python -m repro_torch.launch.serve``) and the serving bench
(``python -m repro_torch.launch.bench_serving``) consume this module, and
it draws exactly what the reference's does, so the same
:class:`TraceSpec` replays a *byte-identical* workload in both packages:
same seed, same prompts, same arrival schedule.

Two independent seeded streams make that reproducibility composable:

* the **payload stream** draws prompt lengths and token ids;
* the **arrival stream** draws open-loop inter-arrival gaps.

They are split (``default_rng([seed, k])``), so changing the offered
``rate`` re-times the workload without changing a single prompt token —
an SLO sweep over rates serves the exact same requests at every point.

Arrivals are **open-loop** (the standard for latency benchmarking, e.g.
vLLM's benchmark client): request *i* is submitted at an absolute offset
``t0 + arrival_s[i]`` drawn from a Poisson process at ``rate`` req/s,
regardless of how far behind the server is — so a server slower than the
offered load accumulates queue depth and its tail latency shows it,
instead of the closed-loop failure mode where a slow server politely
throttles its own load generator.

Prompt-length mixes:

* ``"uniform"`` — lengths uniform over ``[min_prompt, max_prompt]`` (the
  CLI's default workload);
* ``"bimodal"`` — alternate short (``[min_prompt, chunk]``, fits one
  prefill chunk) and long (``[chunk + 1, max_prompt]``, spans several)
  prompts, exercising chunked-prefill/decode interleaving (the paged
  bench rows' workload).

A frontend arch's requests also carry their stub inputs
(:func:`stub_extras`), which the CLIs draw from a third stream,
``default_rng([seed, 2])``, as the reference's CLI does: arming a
frontend leaves the token workload as it was.
"""

from __future__ import annotations

import time as time_lib
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.serve.engine import QueueFull, Request

MIXES = ("uniform", "bimodal")


@dataclass(frozen=True)
class TraceSpec:
    """A reproducible serving workload: fully determined by its fields.

    ``rate`` is the mean offered load in req/s (``0`` = the closed burst:
    every request arrives at t=0). ``chunk`` is the bimodal mix's
    short/long boundary — align it with the engine's ``prefill_chunk`` so
    "short" means single-chunk. ``max_new_tokens`` rides along so one
    spec describes the whole request, not just the prompt.
    """

    requests: int
    seed: int = 0
    rate: float = 0.0
    min_prompt: int = 4
    max_prompt: int = 48
    mix: str = "uniform"
    chunk: int = 16
    max_new_tokens: int = 8

    def __post_init__(self):
        if self.requests < 1:
            raise ValueError(f"requests must be >= 1, got {self.requests}")
        if self.rate < 0:
            raise ValueError(f"rate must be >= 0, got {self.rate}")
        if self.mix not in MIXES:
            raise ValueError(f"unknown mix {self.mix!r}: expected one of "
                             f"{MIXES}")
        if not 1 <= self.min_prompt <= self.max_prompt:
            raise ValueError(
                f"need 1 <= min_prompt <= max_prompt, got "
                f"[{self.min_prompt}, {self.max_prompt}]")
        if self.mix == "bimodal" and not (
                self.min_prompt <= self.chunk < self.max_prompt):
            raise ValueError(
                f"bimodal mix needs min_prompt <= chunk < max_prompt so "
                f"both modes are non-empty, got chunk={self.chunk} with "
                f"prompts in [{self.min_prompt}, {self.max_prompt}]")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")


@dataclass(frozen=True)
class TraceItem:
    """One generated request: arrival offset (seconds from trace start)
    plus the :class:`~repro_torch.serve.Request` payload fields."""

    arrival_s: float
    prompt: Tuple[int, ...]
    max_new_tokens: int

    def request(self, **overrides) -> Request:
        kw = dict(prompt=self.prompt, max_new_tokens=self.max_new_tokens)
        kw.update(overrides)
        return Request(**kw)


def _length(rng: np.random.Generator, spec: TraceSpec, i: int) -> int:
    if spec.mix == "bimodal":
        lo, hi = ((spec.min_prompt, spec.chunk) if i % 2 == 0
                  else (spec.chunk + 1, spec.max_prompt))
    else:
        lo, hi = spec.min_prompt, spec.max_prompt
    return int(rng.integers(lo, hi + 1))


def generate(spec: TraceSpec, vocab_size: int) -> List[TraceItem]:
    """Materialize the workload a :class:`TraceSpec` describes.

    Deterministic in ``(spec, vocab_size)``. Prompts come off the payload
    stream, arrival offsets off the arrival stream — so two specs
    differing only in ``rate`` serve identical prompts on different
    schedules.
    """
    if vocab_size < 1:
        raise ValueError(f"vocab_size must be >= 1, got {vocab_size}")
    payload = np.random.default_rng([spec.seed, 0])
    arrival = np.random.default_rng([spec.seed, 1])
    items, t = [], 0.0
    for i in range(spec.requests):
        n = _length(payload, spec, i)
        prompt = tuple(int(v) for v in
                       payload.integers(0, vocab_size, size=n))
        items.append(TraceItem(arrival_s=t, prompt=prompt,
                               max_new_tokens=spec.max_new_tokens))
        if spec.rate > 0:
            t += float(arrival.exponential(1.0 / spec.rate))
    return items


def stub_extras(cfg, rng: np.random.Generator) -> Optional[dict]:
    """One request's frontend inputs, float32 normals from ``rng``, as the
    reference's CLI and demo draw them: ``frontend_embeds`` (1,
    frontend_tokens, d_model) for a ``vision`` config, then ``frames`` (1,
    enc_seq, d_model) for an encoder one; ``None`` for a text-only
    config, which draws nothing."""
    out = {}
    if cfg.frontend == "vision":
        out["frontend_embeds"] = rng.normal(
            size=(1, cfg.frontend_tokens, cfg.d_model)).astype("float32")
    if cfg.n_enc_layers:
        out["frames"] = rng.normal(
            size=(1, cfg.enc_seq, cfg.d_model)).astype("float32")
    return out or None


def replay(submit: Callable[[Request], Future], items: List[TraceItem],
           *, request_kw: Optional[dict] = None,
           clock: Callable[[], float] = time_lib.monotonic,
           sleep: Callable[[float], None] = time_lib.sleep,
           ) -> Tuple[List[Future], int]:
    """Open-loop replay: submit each item at its absolute arrival offset.

    ``submit`` is anything with the client submit signature —
    ``ServeClient.submit``, ``Router.submit``, or a bare
    ``ServeEngine.submit`` for synchronous tests. A submit shed with
    :class:`~repro_torch.serve.QueueFull` is *counted, not retried* (an
    open-loop generator never blocks on the server); the return is
    ``(futures, shed)`` with one future per accepted request, in
    submission order. ``request_kw`` forwards extra Request fields
    (``extras`` for frontend archs, ``deadline_s`` for SLO traces, …);
    a callable value is invoked per item (fresh per-request extras).
    """
    t0 = clock()
    futures: List[Future] = []
    shed = 0
    for item in items:
        delay = item.arrival_s - (clock() - t0)
        if delay > 0:
            sleep(delay)
        kw = {}
        for k, v in (request_kw or {}).items():
            kw[k] = v() if callable(v) else v
        try:
            futures.append(submit(item.request(**kw)))
        except QueueFull:
            shed += 1
    return futures, shed

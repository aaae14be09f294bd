"""Deterministic, host-sharded synthetic token pipeline with prefetch.

A copy of ``repro.data.pipeline`` (numpy only), so the port and the
reference see byte-identical batches for a given seed.

Production posture without external data deps:

* **Determinism / restart safety** — batch ``i`` is a pure function of
  (seed, step, host shard), so a restarted job resumes mid-stream with no
  drift and no data-state checkpointing beyond the step counter.
* **Host sharding** — each data-parallel host reads only its slice of the
  global batch (disjointness tested).
* **Prefetch** — a background thread keeps a bounded queue of ready batches
  so host data generation overlaps device compute.
* **Structure** — the token stream is a mixture of Zipf-distributed unigrams
  and repeated Markov motifs, so a real LM loss signal exists (models must
  beat the unigram entropy; tests rely on loss *decreasing*).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    motif_len: int = 16
    n_motifs: int = 64
    motif_prob: float = 0.5


class SyntheticLM:
    """Stateless batch generator: ``batch(step) -> {tokens, targets, mask}``."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.host_count:
            raise ValueError("global batch must divide host count")
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        # Zipf-ish unigram distribution over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1)
        probs = 1.0 / ranks
        self.unigram = probs / probs.sum()
        self.motifs = root.integers(
            0, cfg.vocab_size, size=(cfg.n_motifs, cfg.motif_len))

    @property
    def local_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.host_count

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed, step, c.host_index))           # pure function of step
        B, S = self.local_batch, c.seq_len
        toks = rng.choice(c.vocab_size, size=(B, S), p=self.unigram)
        # overwrite random spans with repeated motifs (learnable structure)
        n_spans = max(1, int(c.motif_prob * S / c.motif_len))
        for b in range(B):
            for _ in range(n_spans):
                m = rng.integers(0, c.n_motifs)
                start = rng.integers(0, max(S - c.motif_len, 1))
                toks[b, start:start + c.motif_len] = \
                    self.motifs[m][: S - start]
        toks = toks.astype(np.int32)
        return {"tokens": toks, "targets": toks.copy(),
                "mask": np.ones((B, S), np.float32)}


class Prefetcher:
    """Background-thread prefetch of a deterministic batch stream."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self.queue.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        return self.queue.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2)


def for_model(model: ModelConfig, seq_len: int, global_batch: int,
              seed: int = 0, host_index: int = 0, host_count: int = 1
              ) -> SyntheticLM:
    return SyntheticLM(DataConfig(
        vocab_size=model.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed, host_index=host_index,
        host_count=host_count))

"""Deterministic synthetic data pipeline.

Design goals for the 1000-node story:

* **Deterministic addressing** — batch ``i`` is a pure function of
  ``(seed, i)``; any worker can regenerate any batch, so a restarted or
  re-meshed job resumes mid-epoch with zero coordination (the data-side of
  fault tolerance).
* **Host sharding** — each host materializes only its slice
  (``host_id / n_hosts``), matching how a per-host input pipeline feeds a
  ``jax.Array`` across a pod.
* **Prefetch** — a double-buffered background thread hides host-side
  generation behind device compute.

The token stream is a mixture of a Zipf-like unigram draw and a structured
"copy/induction" pattern so that a language model has learnable signal (loss
decreases), while staying 100 % offline.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["Batch", "SyntheticLMDataset", "prefetch"]


@dataclasses.dataclass
class Batch:
    tokens: np.ndarray          # [B, S+1] int32 — inputs=[:, :-1], labels=[:, 1:]
    step: int

    @property
    def inputs(self) -> np.ndarray:
        return self.tokens[:, :-1]

    @property
    def labels(self) -> np.ndarray:
        return self.tokens[:, 1:]


class SyntheticLMDataset:
    """Deterministic, host-sharded synthetic LM token stream."""

    def __init__(
        self,
        vocab: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        host_id: int = 0,
        n_hosts: int = 1,
        zipf_a: float = 1.2,
        induction_period: int = 64,
    ):
        if global_batch % n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // n_hosts
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.zipf_a = zipf_a
        self.induction_period = induction_period
        # fixed unigram distribution (shared across hosts)
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self._unigram = p / p.sum()
        self._perm = rng.permutation(vocab)

    def batch(self, step: int) -> Batch:
        """Pure function of (seed, step, host): regenerable anywhere."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )
        B, S = self.local_batch, self.seq_len + 1
        toks = self._perm[
            rng.choice(self.vocab, size=(B, S), p=self._unigram)
        ].astype(np.int32)
        # structured signal: periodic copy pattern (induction heads learn it)
        period = self.induction_period
        if S > 2 * period:
            for rep in range(period, S - period, period):
                toks[:, rep : rep + period // 2] = toks[:, :period // 2]
        return Batch(tokens=toks, step=step)

    def __iter__(self) -> Iterator[Batch]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def prefetch(it: Iterator[Batch], depth: int = 2) -> Iterator[Batch]:
    """Double-buffered background prefetch (overlap host gen with compute)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _SENTINEL = object()

    def producer():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            return
        yield item

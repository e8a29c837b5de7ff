"""Data pipeline: Zipf token batches, background prefetch and the
splay vocab cache's frequency tap (the twin of ``repro.train.data``).

``SyntheticZipfData.batch_at(step)`` is a pure function of the seed and
the step, and equals the reference's for equal seeds.  Iterating the
source feeds each batch's ids to a ``SplayVocabCache``, whose hot-set
refresh (every ``refresh_every`` observed batches) runs torch ops on
the cache's device; under ``PrefetchLoader`` that happens on the
loader's thread, as in the reference.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core.splay_cache import SplayVocabCache
from repro_torch.core.workload import zipf_token_ids


class SyntheticZipfData:
    """Deterministic, restartable synthetic LM data (Zipf token ids).
    Set ``step`` before iterating to start at a later batch."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 s: float = 1.0, seed: int = 0,
                 cache: Optional[SplayVocabCache] = None):
        self.vocab, self.seq_len, self.global_batch = (vocab, seq_len,
                                                       global_batch)
        self.s = s
        self.seed = seed
        self.cache = cache
        self.step = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        toks = zipf_token_ids(rng, self.vocab,
                              (self.global_batch, self.seq_len), self.s)
        return {"tokens": toks, "labels": toks.copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            b = self.batch_at(self.step)
            if self.cache is not None:
                self.cache.observe(b["tokens"])
            self.step += 1
            yield b


class PrefetchLoader:
    """Background-thread prefetch: the thread starts at once and keeps
    ``prefetch`` batches ahead, so position the source first."""

    def __init__(self, source, prefetch: int = 4):
        self.source = iter(source)
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._fill, daemon=True)
        self.t.start()

    def _fill(self):
        for item in self.source:
            if self._stop.is_set():
                return
            self.q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        """Stop the thread and wait for it (at most a minute): drain the
        queue until it leaves its loop (it makes at most one more
        batch)."""
        self._stop.set()
        deadline = time.monotonic() + 60.0
        while self.t.is_alive() and time.monotonic() < deadline:
            try:
                self.q.get(timeout=0.1)
            except queue.Empty:
                pass
        self.t.join(timeout=1.0)

"""Synthetic LM data pipeline (the port of the JAX package's
``data/pipeline.py``), pure numpy.

A seeded, deterministic token source with document structure and a Zipfian
unigram-with-Markov-bigram mixture, batched per data-parallel shard with a
background prefetch thread.  The same seed gives the same token ids as the
JAX package's ``SyntheticLM``, bit for bit: every draw consumes the same
generator stream in the same order.  Each unigram draw is the inverse-CDF
lookup that ``Generator.choice(V, p=unigram)`` performs, with the CDF built
once instead of on every draw (``choice`` recomputes it, O(V) a token).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

EOD = 0


class SyntheticLM:
    """Deterministic synthetic corpus sampler."""

    def __init__(self, vocab_size: int, seed: int = 0,
                 doc_len_mean: int = 512, bigram_tables: int = 64):
        self.vocab = vocab_size
        self.seed = seed
        self.doc_len_mean = doc_len_mean
        rng = np.random.default_rng(seed)
        # Zipf unigram distribution
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks ** 1.1)
        self.unigram /= self.unigram.sum()
        # what Generator.choice(p=unigram) builds on every call
        self._cdf = self.unigram.cumsum()
        self._cdf /= self._cdf[-1]
        # low-rank bigram structure: each token has a "successor cluster"
        self.n_clusters = bigram_tables
        self.tok_cluster = rng.integers(0, bigram_tables, size=vocab_size)
        self.cluster_tokens = [
            rng.choice(vocab_size, size=max(8, vocab_size // bigram_tables),
                       p=self.unigram, replace=True)
            for _ in range(bigram_tables)
        ]

    def _unigram_draw(self, rng: np.random.Generator) -> int:
        """``int(rng.choice(self.vocab, p=self.unigram))``: one uniform
        double, looked up in the CDF."""
        return int(self._cdf.searchsorted(rng.random(), side="right"))

    def sample_tokens(self, n: int, stream: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed + 1) * 1_000_003 + stream)
        out = np.empty(n, dtype=np.int32)
        i = 0
        while i < n:
            doc_len = max(8, int(rng.exponential(self.doc_len_mean)))
            tok = self._unigram_draw(rng)
            for _ in range(min(doc_len, n - i)):
                out[i] = tok
                i += 1
                if rng.random() < 0.7:   # bigram continuation
                    cl = self.tok_cluster[tok]
                    tok = int(rng.choice(self.cluster_tokens[cl]))
                else:
                    tok = self._unigram_draw(rng)
            if i < n:
                out[i] = EOD
                i += 1
        return out


def batches(source: SyntheticLM, batch: int, seq_len: int, shard: int = 0,
            n_shards: int = 1, prefetch: int = 2,
            ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {'ids': (batch, seq), 'labels': (batch, seq)} for this shard.

    Streams are partitioned by shard so data-parallel replicas see disjoint
    data (each PS worker computes on its own partition, as in the paper)."""

    def produce(q: queue.Queue):
        step = 0
        while True:
            ids = np.stack([
                source.sample_tokens(seq_len + 1,
                                     stream=(step * batch + i) * n_shards + shard)
                for i in range(batch)
            ])
            q.put({"ids": ids[:, :-1], "labels": ids[:, 1:].copy()})
            step += 1

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    t = threading.Thread(target=produce, args=(q,), daemon=True)
    t.start()
    while True:
        yield q.get()

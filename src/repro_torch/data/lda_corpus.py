"""Synthetic LDA corpus generator (20News-scale; paper Table 1).

Documents are drawn from a ground-truth LDA model so that a correct
collapsed-Gibbs implementation measurably recovers structure (rising
log-likelihood), and different consistency models can be compared on the
same corpus.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class LDACorpus:
    docs: List[np.ndarray]          # token id arrays
    vocab_size: int
    n_topics_true: int

    @property
    def n_docs(self) -> int:
        return len(self.docs)

    @property
    def n_tokens(self) -> int:
        return int(sum(len(d) for d in self.docs))


def synthetic_corpus(n_docs: int = 200, vocab_size: int = 1000,
                     n_topics: int = 10, doc_len: int = 120,
                     alpha: float = 0.1, beta: float = 0.01,
                     seed: int = 0) -> LDACorpus:
    rng = np.random.default_rng(seed)
    topics = rng.dirichlet(np.full(vocab_size, beta + 0.05), size=n_topics)
    docs = []
    for _ in range(n_docs):
        theta = rng.dirichlet(np.full(n_topics, alpha + 0.05))
        n = max(10, int(rng.poisson(doc_len)))
        zs = rng.choice(n_topics, size=n, p=theta)
        ws = np.array([rng.choice(vocab_size, p=topics[z]) for z in zs],
                      dtype=np.int32)
        docs.append(ws)
    return LDACorpus(docs=docs, vocab_size=vocab_size, n_topics_true=n_topics)

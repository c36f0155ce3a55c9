"""Collapsed-Gibbs LDA on the asynchronous parameter server (paper §5).

The shared state lives in two PS keys — ``word_topic`` (V × K counts) and
``topic`` (K counts) — exactly the tables YahooLDA/Petuum shard; per-document
topic counts and assignments are worker-local.  Each clock a worker sweeps
its document shard with collapsed Gibbs against its (possibly stale /
value-bounded) view and emits the count deltas, which is the paper's
evaluation workload for the consistency models.

The same application runs on two implementations of the spec:

  * ``backend="sim"``      — the deterministic event-driven simulator
                             (:class:`repro_torch.core.server.AsyncPS`),
                             host numpy;
  * ``backend="runtime"``  — the real threaded PS
                             (:class:`repro_torch.runtime.PSRuntime`), its
                             master tables on ``device`` (the card unless the
                             caller asks for the CPU).

The SPMD sync-layer backend (``run_lda_spmd``) is ROADMAP Queue 1 item 3.

``snapshot_trajectory=True`` switches the log-likelihood recording to
*period-start snapshots*: each worker captures its own doc-topic state and
worker 0 captures the PS view at the top of every period, before sweeping.
Those captures are worker-local, so the resulting trajectory is free of
cross-thread races — under BSP (with ``barrier_reads`` on the runtime) both
backends produce element-wise identical trajectories, and identical to the
JAX package's, which the port's tests assert.  Count deltas are integers, so float accumulation
is exact and order-independent.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.policies import Policy
from repro_torch.core.server import AsyncPS, NetworkModel
from repro_torch.data.lda_corpus import LDACorpus


class _WorkerState:
    def __init__(self, docs, n_topics: int, rng: np.random.Generator):
        self.docs = docs
        self.assign = [rng.integers(0, n_topics, size=len(d)) for d in docs]
        self.doc_topic = np.zeros((len(docs), n_topics), dtype=np.float64)
        for i, zs in enumerate(self.assign):
            np.add.at(self.doc_topic[i], zs, 1.0)


def _initial_counts(states: List[_WorkerState], vocab: int, K: int):
    wt = np.zeros((vocab, K))
    tc = np.zeros(K)
    for st in states:
        for d, zs in zip(st.docs, st.assign):
            np.add.at(wt, (d, zs), 1.0)
            np.add.at(tc, zs, 1.0)
    return wt, tc


def _init_states(corpus: LDACorpus, n_topics: int, n_workers: int, seed: int):
    rng = np.random.default_rng(seed)
    shards = [list(range(w, corpus.n_docs, n_workers))
              for w in range(n_workers)]
    states = [_WorkerState([corpus.docs[i] for i in sh], n_topics, rng)
              for sh in shards]
    wt0, tc0 = _initial_counts(states, corpus.vocab_size, n_topics)
    return shards, states, wt0, tc0


def log_likelihood(corpus: LDACorpus, wt: np.ndarray, tc: np.ndarray,
                   doc_topic: np.ndarray, doc_ids, alpha: float,
                   beta: float) -> float:
    """doc_topic rows follow the order of doc_ids (concatenated shards)."""
    V, K = wt.shape
    phi = (wt + beta) / (tc + V * beta)[None, :]           # (V, K)
    ll = 0.0
    for row, gid in enumerate(doc_ids):
        d = corpus.docs[gid]
        theta = doc_topic[row] + alpha
        theta = theta / theta.sum()
        p = phi[d] @ theta
        ll += float(np.log(np.maximum(p, 1e-12)).sum())
    return ll


def _gibbs_sweep(st: _WorkerState, wt: np.ndarray, tc: np.ndarray,
                 V: int, alpha: float, beta: float,
                 wrng: np.random.Generator):
    """One collapsed-Gibbs sweep over a worker's shard; returns count deltas."""
    K = tc.shape[0]
    d_wt = np.zeros_like(wt)
    d_tc = np.zeros_like(tc)
    for di, doc in enumerate(st.docs):
        dt = st.doc_topic[di]
        zs = st.assign[di]
        for ti, word in enumerate(doc):
            z = zs[ti]
            # remove current assignment (local view)
            dt[z] -= 1
            d_wt[word, z] -= 1
            d_tc[z] -= 1
            nw = np.maximum(wt[word] + d_wt[word] + beta, beta)
            nt = np.maximum(tc + d_tc + V * beta, V * beta)
            p = (dt + alpha) * nw / nt
            p = np.maximum(p, 1e-12)
            z_new = wrng.choice(K, p=p / p.sum())
            zs[ti] = z_new
            dt[z_new] += 1
            d_wt[word, z_new] += 1
            d_tc[z_new] += 1
    return d_wt, d_tc


class _Snapshots:
    """Period-start captures, written by each worker under distinct keys."""

    def __init__(self):
        self.doc: Dict[Tuple[int, int], np.ndarray] = {}   # (worker, clock)
        self.view: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}  # clock

    def trajectory(self, corpus: LDACorpus, shards, n_workers: int,
                   n_clocks: int, alpha: float, beta: float) -> List[float]:
        ids = [i for sh in shards for i in sh]
        lls = []
        for c in range(n_clocks):
            wt, tc = self.view[c]
            dt_all = np.concatenate([self.doc[(w, c)]
                                     for w in range(n_workers)])
            lls.append(log_likelihood(corpus, wt, tc, dt_all, ids,
                                      alpha, beta))
        return lls


def _make_update_fn(states: List[_WorkerState], V: int, alpha: float,
                    beta: float, snapshots: Optional[_Snapshots] = None):
    def update_fn(w: int, clock: int, view, wrng: np.random.Generator):
        st = states[w]
        wt = view.get("word_topic")
        tc = view.get("topic")
        if snapshots is not None:
            # worker-local + before the sweep: race-free and deterministic
            snapshots.doc[(w, clock)] = st.doc_topic.copy()
            if w == 0:
                snapshots.view[clock] = (wt.copy(), tc.copy())
        d_wt, d_tc = _gibbs_sweep(st, wt, tc, V, alpha, beta, wrng)
        return {"word_topic": d_wt, "topic": d_tc}
    return update_fn


def run_lda(corpus: LDACorpus, n_topics: int, policy: Policy,
            n_workers: int, n_clocks: int, alpha: float = 0.1,
            beta: float = 0.01, seed: int = 0,
            network: Optional[NetworkModel] = None,
            straggler=None, collect_stats: bool = False,
            backend: str = "runtime", threads_per_process: int = 1,
            n_shards: int = 2, barrier_reads: bool = False,
            snapshot_trajectory: bool = False, timeout: float = 300.0,
            device: Optional[str] = None, return_ps: bool = False):
    """Returns the per-clock corpus log-likelihood list (and stats if asked).

    ``backend="runtime"`` (the default) runs the real threaded PS
    (``threads_per_process`` / ``n_shards`` / ``barrier_reads`` configure it;
    latency is wall-clock, so ``network`` and ``straggler`` are ignored) with
    its master tables on ``device``: the card when ``device`` is None, the CPU
    only when the caller asks for ``"cpu"``.  ``backend="sim"`` runs the
    event-driven simulator (``network`` / ``straggler`` model the cluster),
    which is host numpy: it takes ``device`` None or ``"cpu"`` and raises on
    any other.

    ``return_ps=True`` appends the finished server (the ``AsyncPS`` or the
    ``PSRuntime``) to the result, so the caller can read the trained
    ``word_topic`` / ``topic`` tables with ``master_value``.
    """
    V, K = corpus.vocab_size, n_topics
    shards, states, wt0, tc0 = _init_states(corpus, n_topics, n_workers, seed)

    snapshots = _Snapshots() if snapshot_trajectory else None
    update_fn = _make_update_fn(states, V, alpha, beta, snapshots)

    lls: List[float] = []

    # wrap update_fn to record the log-likelihood once per full clock
    # (legacy recording: approximate under the threaded runtime, where peer
    # doc-topic states are mid-sweep; use snapshot_trajectory for exactness)
    def wrapped(w, clock, view, wrng):
        out = update_fn(w, clock, view, wrng)
        if w == 0 and snapshots is None:
            wt = view.get("word_topic")
            tc = view.get("topic")
            dt_all = np.concatenate([s.doc_topic for s in states])
            ids = [i for sh in shards for i in sh]
            lls.append(log_likelihood(corpus, wt, tc, dt_all, ids, alpha, beta))
        return out

    if backend == "sim":
        if device not in (None, "cpu"):
            raise ValueError(f"backend='sim' runs on the host; it cannot "
                             f"run on device={device!r}")
        # a clock sweeps the worker's shard once: compute time ∝ tokens owned
        # (per-token Gibbs cost normalized to 1ms) — strong scaling shrinks it
        tokens_of = [sum(len(d) for d in st.docs) for st in states]
        ps = AsyncPS(n_workers, policy,
                     {"word_topic": wt0, "topic": tc0},
                     network=network or NetworkModel(seed=seed),
                     compute_time=lambda w: 0.001 * tokens_of[w],
                     straggler=straggler, seed=seed)
        stats = ps.run(wrapped, n_clocks)
    elif backend == "runtime":
        from repro_torch.runtime import PSRuntime, RuntimeConfig
        ps = PSRuntime(RuntimeConfig(n_workers, policy,
                       {"word_topic": wt0, "topic": tc0},
                       n_shards=n_shards,
                       threads_per_process=threads_per_process,
                       seed=seed, barrier_reads=barrier_reads,
                       device=device or "cuda"))
        stats = ps.run(wrapped, n_clocks, timeout=timeout)
    else:
        raise ValueError(f"unknown backend {backend!r}")

    if snapshots is not None:
        lls = snapshots.trajectory(corpus, shards, n_workers, n_clocks,
                                   alpha, beta)
    out = (lls, stats) if collect_stats else (lls,)
    if return_ps:
        out += (ps,)
    return out if len(out) > 1 else lls

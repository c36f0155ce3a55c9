"""The port's LDA workload against the JAX package's.

Under BSP, period-start snapshot trajectories are element-wise identical
across the reference simulator, the port's simulator and the port's runtime
(``barrier_reads``), because count deltas are integers and float
accumulation is exact.  The runtime runs with ``device="cpu"`` here.
"""
import numpy as np

from repro.apps import lda as ref_lda
from repro.core import NetworkModel as RefNetworkModel
from repro.core import policies as ref_policies
from repro.data import synthetic_corpus as ref_corpus
from repro_torch.apps import lda
from repro_torch.core import NetworkModel, policies
from repro_torch.data import synthetic_corpus

_CORPUS = dict(n_docs=12, vocab_size=24, n_topics=3, doc_len=15, seed=1)
_KW = dict(n_topics=3, n_workers=3, n_clocks=4, seed=0)


def test_corpus_matches_reference():
    mine, ref = synthetic_corpus(**_CORPUS), ref_corpus(**_CORPUS)
    assert mine.vocab_size == ref.vocab_size and mine.n_docs == ref.n_docs
    for a, b in zip(mine.docs, ref.docs):
        np.testing.assert_array_equal(a, b)


def test_lda_bsp_trajectories_match_reference():
    corpus = synthetic_corpus(**_CORPUS)
    # the reference simulator: latency >> compute spread makes BSP a barrier
    lls_ref = ref_lda.run_lda(
        ref_corpus(**_CORPUS), policy=ref_policies.bsp(), backend="sim",
        network=RefNetworkModel(base_delay=100.0, jitter=0.0, seed=0),
        snapshot_trajectory=True, **_KW)
    lls_sim = lda.run_lda(
        corpus, policy=policies.bsp(), backend="sim",
        network=NetworkModel(base_delay=100.0, jitter=0.0, seed=0),
        snapshot_trajectory=True, **_KW)
    lls_rt = lda.run_lda(
        corpus, policy=policies.bsp(), backend="runtime", barrier_reads=True,
        threads_per_process=1, n_shards=2, snapshot_trajectory=True,
        device="cpu", **_KW)
    assert len(lls_ref) == _KW["n_clocks"]
    np.testing.assert_allclose(lls_sim, lls_ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(lls_rt, lls_ref, rtol=0, atol=1e-9)
    assert lls_ref[-1] != lls_ref[0]        # the chain is sampling


def test_lda_runtime_trains_under_vap():
    corpus = synthetic_corpus(n_docs=12, vocab_size=30, n_topics=3,
                              doc_len=20, seed=0)
    lls, stats = lda.run_lda(corpus, n_topics=3, policy=policies.vap(5.0),
                             n_workers=4, n_clocks=6, seed=0,
                             backend="runtime", threads_per_process=2,
                             n_shards=2, collect_stats=True, device="cpu")
    assert stats.violations == []
    assert lls[-1] > lls[0], lls


def test_lda_runtime_master_is_exact_counts():
    """What the card run asserts, at a small size on the CPU: the master is
    exactly x0 + Σ updates, holds every token once, and topic is the column
    sum of word_topic."""
    corpus = synthetic_corpus(n_docs=16, vocab_size=40, n_topics=4,
                              doc_len=20, seed=2)
    lls, stats, rt = lda.run_lda(
        corpus, n_topics=5, policy=policies.ssp(1), n_workers=4, n_clocks=3,
        seed=0, backend="runtime", n_shards=2, collect_stats=True,
        return_ps=True, device="cpu")
    assert stats.violations == []
    wt, tc = rt.master_value("word_topic"), rt.master_value("topic")
    np.testing.assert_array_equal(wt, rt.expected_value("word_topic"))
    np.testing.assert_array_equal(tc, rt.expected_value("topic"))
    assert wt.shape == (40, 5) and wt.sum() == corpus.n_tokens
    assert (wt >= 0).all() and np.array_equal(wt, np.round(wt))
    np.testing.assert_array_equal(tc, wt.sum(0))
    assert np.isfinite(lls).all() and lls[-1] > lls[0]

from repro_torch.data.lda_corpus import LDACorpus, synthetic_corpus

__all__ = ["LDACorpus", "synthetic_corpus"]

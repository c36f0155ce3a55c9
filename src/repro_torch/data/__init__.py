from repro_torch.data.lda_corpus import LDACorpus, synthetic_corpus
from repro_torch.data.pipeline import SyntheticLM, batches

__all__ = ["LDACorpus", "SyntheticLM", "batches", "synthetic_corpus"]

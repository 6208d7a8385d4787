"""Karpathy CSV corpora (``CrossModalCorpus``) and caption tokenization for
sparse-term candidates (copies of the JAX package's ``data/karpathy.py``
and ``data/tokenization.py``)."""

from mllm_sparse_retrieval_tpu_torch.data.karpathy import (
    CrossModalCorpus, Example, shard_examples)
from mllm_sparse_retrieval_tpu_torch.data.tokenization import (
    ENGLISH_STOPWORDS, STOP_SET, caption_words, word_tokenize)

__all__ = ["CrossModalCorpus", "ENGLISH_STOPWORDS", "Example", "STOP_SET",
           "caption_words", "shard_examples", "word_tokenize"]

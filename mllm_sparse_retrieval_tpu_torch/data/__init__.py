"""Caption tokenization for sparse-term candidates (copy of the JAX
package's ``data/tokenization.py``) and the retrieval ``Example``."""

from mllm_sparse_retrieval_tpu_torch.data.karpathy import Example
from mllm_sparse_retrieval_tpu_torch.data.tokenization import (
    ENGLISH_STOPWORDS, STOP_SET, caption_words, word_tokenize)

__all__ = ["ENGLISH_STOPWORDS", "Example", "STOP_SET", "caption_words",
           "word_tokenize"]

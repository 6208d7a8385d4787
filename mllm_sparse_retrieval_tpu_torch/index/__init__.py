"""Indexes scored on the device: the impact index, the dense flat index
(f32, bf16 or SQ8 int8) and its approximate tier, and the doc filters they
take."""

from mllm_sparse_retrieval_tpu_torch.index.ann import DenseANNIndex
from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
from mllm_sparse_retrieval_tpu_torch.index.filter import DocFilter
from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex

__all__ = ["DenseANNIndex", "DenseFlatIndex", "DocFilter", "ImpactIndex"]

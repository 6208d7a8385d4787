"""Indexes scored on the device: the impact index and the dense flat
index, and the doc filters both take."""

from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
from mllm_sparse_retrieval_tpu_torch.index.filter import DocFilter
from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex

__all__ = ["DenseFlatIndex", "DocFilter", "ImpactIndex"]

"""Indexes scored on the device: the impact index and the dense flat
index."""

from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex

__all__ = ["DenseFlatIndex", "ImpactIndex"]

"""Indexes scored on the device: the impact index, the dense flat index
(f32, bf16 or SQ8 int8) and its approximate tier, the doc filters they
take, and their live forms: the arena indexes (in-place device writes) and
the segment indexes (delta segments and a host merge)."""

from mllm_sparse_retrieval_tpu_torch.index.ann import DenseANNIndex
from mllm_sparse_retrieval_tpu_torch.index.arena import (
    ArenaDenseIndex, ArenaImpactIndex)
from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
from mllm_sparse_retrieval_tpu_torch.index.filter import DocFilter
from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex
from mllm_sparse_retrieval_tpu_torch.index.live import (
    LiveDenseIndex, LiveImpactIndex)

__all__ = ["ArenaDenseIndex", "ArenaImpactIndex", "DenseANNIndex",
           "DenseFlatIndex", "DocFilter", "ImpactIndex", "LiveDenseIndex",
           "LiveImpactIndex"]

"""Indexes scored on the card (the impact index in this slice)."""

from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex

__all__ = ["ImpactIndex"]

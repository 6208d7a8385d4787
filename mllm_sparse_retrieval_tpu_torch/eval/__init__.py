"""Evaluation on the host: recall@k (the reference's metric) and
MRR/nDCG/MAP."""

from mllm_sparse_retrieval_tpu_torch.eval.metrics import (
    MetricResult, map_at_k, mrr_at_k, ndcg_at_k, ranking_metrics)
from mllm_sparse_retrieval_tpu_torch.eval.recall import (
    DEFAULT_KS, RecallResult, recall_at_k)

__all__ = ["DEFAULT_KS", "MetricResult", "RecallResult", "map_at_k",
           "mrr_at_k", "ndcg_at_k", "ranking_metrics", "recall_at_k"]

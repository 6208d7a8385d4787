"""Online serving: micro-batched sparse, dense and hybrid retrieval with
live text and image encoding."""

from mllm_sparse_retrieval_tpu_torch.serving.batcher import MicroBatcher
from mllm_sparse_retrieval_tpu_torch.serving.encoder import OnlineQueryEncoder
from mllm_sparse_retrieval_tpu_torch.serving.service import (
    QueryRequest, RetrievalService)

__all__ = ["MicroBatcher", "OnlineQueryEncoder", "QueryRequest",
           "RetrievalService"]

"""Online serving: micro-batched sparse, dense and hybrid retrieval over
static or live indexes, with live text and image encoding, and its HTTP
front ends (``serving.aio``, ``serving.http``, routed by
``serving.router``)."""

from mllm_sparse_retrieval_tpu_torch.serving.batcher import MicroBatcher
from mllm_sparse_retrieval_tpu_torch.serving.encoder import OnlineQueryEncoder
from mllm_sparse_retrieval_tpu_torch.serving.service import (
    QueryRequest, RetrievalService, load_live_state)

__all__ = ["MicroBatcher", "OnlineQueryEncoder", "QueryRequest",
           "RetrievalService", "load_live_state"]

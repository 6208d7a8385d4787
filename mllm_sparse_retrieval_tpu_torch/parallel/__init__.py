"""Parallel layers. On one device so far: the mixture-of-experts FFN
(``ep.py``). Meshes, sharding and their collectives wait for a later
slice."""

from mllm_sparse_retrieval_tpu_torch.parallel.ep import (
    MoEConfig, expert_capacity, moe_ffn, moe_init)

__all__ = ["MoEConfig", "expert_capacity", "moe_ffn", "moe_init"]

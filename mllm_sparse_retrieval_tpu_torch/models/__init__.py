"""Text tower of the MLLM families (Llama decoder, reps heads, registry)."""

from mllm_sparse_retrieval_tpu_torch.models.registry import (
    FamilySpec, build_model, get_family_spec)

__all__ = ["FamilySpec", "build_model", "get_family_spec"]

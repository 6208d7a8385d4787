"""Model-agnostic encode dispatch (text-only families in this slice)."""

from __future__ import annotations

from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc
from mllm_sparse_retrieval_tpu_torch.models import mllm


def encode_any(params, arch, input_ids, attention_mask, vision_input=None,
               reps_loc: RepsLoc = RepsLoc.BEFORE_PAD):
    """``(sparse [B, V], dense [B, H])``. Image inputs wait for the
    image-query slice and raise."""
    if vision_input is not None:
        raise NotImplementedError("image inputs are not ported yet")
    return mllm.encode(params, arch, input_ids, attention_mask, reps_loc)

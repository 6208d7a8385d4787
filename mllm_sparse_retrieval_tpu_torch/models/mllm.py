"""LLaVA-style MLLM composition, text branch.

The JAX package splices projected image features into the prompt before the
decoder; this slice serves text queries, so the config carries the text
tower only and ``forward_hidden`` takes no pixels. The vision tower and the
splice wait for the image-query slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
from torch.profiler import record_function

from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc
from mllm_sparse_retrieval_tpu_torch.models import llama
from mllm_sparse_retrieval_tpu_torch.models import reps as R
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig


@dataclass(frozen=True)
class MLLMConfig:
    text: LlamaConfig = field(default_factory=LlamaConfig)
    image_token_id: int = 4


def init_params(cfg: MLLMConfig, generator: torch.Generator, device="cuda",
                dtype=torch.bfloat16) -> Dict:
    """Random text-tower weights drawn on ``device`` (see
    ``llama.init_params``)."""
    return {"text": llama.init_params(cfg.text, generator, device, dtype)}


@torch.no_grad()
def forward_hidden(params: Dict, cfg: MLLMConfig, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor) -> torch.Tensor:
    """Final-layer hidden states ``[B, T, H]`` for text inputs."""
    embeds = llama.embed_tokens(params["text"], input_ids)
    return llama.apply(params["text"], embeds, attention_mask, cfg.text)


@torch.no_grad()
def encode(params: Dict, cfg: MLLMConfig, input_ids: torch.Tensor,
           attention_mask: torch.Tensor,
           reps_loc: RepsLoc = RepsLoc.BEFORE_PAD
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sparse_weights [B, V] f32, dense_embs [B, H])`` for text. The
    ``tower`` and ``lm_head`` ranges name the two stages in a profiler
    trace."""
    with record_function("tower"):
        hidden = forward_hidden(params, cfg, input_ids, attention_mask)
    with record_function("lm_head"):
        head = llama.lm_head_weight(params["text"], cfg.text)
        return R.extract_reps(hidden, attention_mask, head, reps_loc)

"""Representation heads: padding-aware last-token gather, dense + sparse reps.

- ``reps_loc='before_pad'`` reads the last non-pad position
  (``attention_mask.sum(-1) - 1``); ``'after_pad'`` the raw final position;
- dense embedding = final-layer hidden state at that position;
- sparse vocab weights = ``log(1 + relu(logits))`` at that position, with
  the LM head applied at that ONE position only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc

# vocab columns per f32 upcast of a low-precision LM head (~134 MB of f32
# scratch at hidden 4096)
_HEAD_CHUNK = 8192


def select_rep_positions(attention_mask: torch.Tensor,
                         reps_loc: RepsLoc) -> torch.Tensor:
    """``[B, T]`` mask -> ``[B]`` gather positions."""
    if reps_loc == RepsLoc.AFTER_PAD:
        t = attention_mask.shape[1]
        return torch.full((attention_mask.shape[0],), t - 1, dtype=torch.long,
                          device=attention_mask.device)
    return attention_mask.long().sum(dim=-1) - 1


def head_logits(h_sel: torch.Tensor, head_weight: torch.Tensor
                ) -> torch.Tensor:
    """``[B, H] @ [H, V]`` with f32 products and f32 accumulation (the JAX
    package's ``preferred_element_type=float32``): a bf16 head is upcast
    chunk by chunk, so the logits are never rounded to bf16 and no full f32
    copy of the head is held."""
    h32 = h_sel.float()
    if head_weight.dtype == torch.float32:
        return h32 @ head_weight
    v = head_weight.shape[1]
    out = torch.empty((h32.shape[0], v), dtype=torch.float32,
                      device=h32.device)
    for c0 in range(0, v, _HEAD_CHUNK):
        c1 = min(v, c0 + _HEAD_CHUNK)
        out[:, c0:c1] = h32 @ head_weight[:, c0:c1].float()
    return out


def extract_reps(hidden: torch.Tensor, attention_mask: torch.Tensor,
                 head_weight: torch.Tensor,
                 reps_loc: RepsLoc = RepsLoc.BEFORE_PAD
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(sparse_weights [B, V] float32, dense_embs [B, H])``."""
    pos = select_rep_positions(attention_mask, reps_loc)
    batch = torch.arange(hidden.shape[0], device=hidden.device)
    h_sel = hidden[batch, pos]
    sparse = torch.log1p(torch.relu(head_logits(h_sel, head_weight)))
    return sparse, h_sel


def normalize(embs: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along the last axis in f32 (denominator clamped at
    ``eps``), cast back to the input dtype."""
    e = embs.float()
    norm = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    return (e / torch.clamp(norm, min=eps)).to(embs.dtype)


def cosine_similarity_matrix(a: torch.Tensor, b: torch.Tensor
                             ) -> torch.Tensor:
    """``[Na, Nb]`` cosine similarities of two embedding batches (the rows
    normalized as ``normalize`` does)."""
    return normalize(a) @ normalize(b).T
